"""Buffers and bookkeeping of one multi-rank op (``sendrecv``, ``gather``).

gloo's sends, receives and collectives read and write host memory, so on
gloo a CUDA tensor is copied to a pinned host buffer before the message and
back to its device after it, in plain sight; other backends get the
tensor itself, made contiguous (``torch.distributed`` refuses strided
views such as a column ``a[:, 1]``).  ``Exchange`` is that policy for one
op, and ``stats`` counts what the ops of this process cost.  An async
collective (``ops/_async.py``) keeps its ``Exchange`` in its handle: its
start stages the tensor and issues the work (``start``/``stop``), and its
wait brings the result back, the pinned host buffer alive until then.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist


class ExchangeStats:
    """Multi-rank ops of this process: ``calls``, ``staged_bytes``
    (device-to-host plus host-to-device copies for gloo) and ``seconds``
    (host wall time inside the ops, staging included; device work queued
    before an op is waited for first and not counted, but waiting for a
    slower peer is)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = 0
        self.staged_bytes = 0
        self.seconds = 0.0


stats = ExchangeStats()


class Exchange:
    """One multi-rank op whose result lives on ``device``.  ``send(t)``
    gives the tensor to hand ``torch.distributed``, ``buffer(like)`` an
    empty receive buffer, ``result(t)`` a received tensor back on
    ``device``.  Used as a context manager, it times the op into
    ``stats``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host = dist.get_backend() == "gloo"

    def start(self, sync: bool = True) -> None:
        """Start timing.  ``sync``: on gloo, first wait for the device work
        queued before (the first staging copy would wait anyway); an async
        wait passes ``False``, so that the compute issued since its start
        is not counted as exchange time."""
        if sync and self.host and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._start = time.perf_counter()

    def stop(self, calls: int = 1) -> None:
        """Stop timing; ``calls`` collectives were issued since ``start``."""
        stats.calls += calls
        stats.seconds += time.perf_counter() - self._start

    def __enter__(self) -> "Exchange":
        self.start()
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    def send(self, t: torch.Tensor) -> torch.Tensor:
        if not self.host or t.device.type == "cpu":
            return t.contiguous()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        stats.staged_bytes += t.numel() * t.element_size()
        return host

    def buffer(self, like: torch.Tensor) -> torch.Tensor:
        if not self.host:
            return torch.empty_like(like, memory_format=torch.contiguous_format)
        return torch.empty(like.shape, dtype=like.dtype,
                           pin_memory=like.device.type == "cuda")

    def result(self, t: torch.Tensor, non_blocking: bool = False) -> torch.Tensor:
        """``non_blocking``: the copy back does not wait for the device's
        queued work (the pinned buffer stays reserved until it is done)."""
        if not self.host or self.device.type == "cpu":
            return t
        stats.staged_bytes += t.numel() * t.element_size()
        return t.to(self.device, non_blocking=non_blocking)
