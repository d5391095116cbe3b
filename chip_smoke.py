"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's kernels from the seven sources in this checkout (one
``nvcc`` each, all at once), holds each against its plain PyTorch version
at the full width of its path (the stencils bit for bit),
prints each stencil kernel's blocks resident per SM and the cells it
computes per cell it keeps, drives the paths that run them, checks
that each path launched its kernels and that its output is right, and
prints:

- the card's name and power limit (nvidia-smi), and the versions;
- one JSON line ``{"kernels": [...]}`` with each kernel's launches on its
  path, its largest difference from the plain version, its time, the
  plain version's time, the least time the card could take and, where
  one PyTorch call computes the same function, that call's time;
- as the last line ``{"ok": true, "device": {...}}``.

The paths, each driven with the launch counts set to 0 just before it and
read just after:

1. the single-GPU main path: ``solve_fused(fast="auto", pinned=True)`` at
   3600x1800 for 0.1 simulated days, periodic in x, through ``sw_steps``;
2. the single-GPU walled solve: the same with ``periodic_x=False``, where
   "auto" picks the wide-halo pair kernel ``sw_wide``;
3. the single-GPU split-phase solve: the periodic config through
   ``solve_fused(fast="pallas_halo", pinned=True)``, two ``sw_phase``
   launches a step, its final state against the ``fast=True`` path's bit
   for bit;
4. four ranks on a (2,2) grid (gloo, all four processes on this one card,
   exchanges staged through host memory): the 0.1-day solve through
   ``sw_wide``, and 20 steps of the split-phase path through ``sw_phase``.
   Four processes share one card, so these times are not a scaling result.
5. long-context attention at the width the JAX package measured its flash
   kernel at (B=4, T=4096, H=8, D=128, f32): the forward kernels against
   their plain version (f32: the 3xTF32 tensor-core ``flash_fwd_tf32``,
   ``flash_fwd_causal_tf32``, whose library must hold TF32 ``HMMA``
   instructions; bf16: the tensor-core ``flash_fwd_mma``,
   ``flash_fwd_causal_mma``), masked, ragged, fully masked and through a
   query view of stride 4, beside ``scaled_dot_product_attention``;
   single-GPU ``flash_attention``,
   causal and not, against ``reference_attention``; and the demo's entry
   point (``models.long_context_attention.main``) on four gloo ranks on
   this card, 1024 tokens each: causal and non-causal ring, causal
   Ulysses, each rank against its slice of single-GPU ``flash_attention``.
6. long-context training at the same width: the backward kernels against
   their plain version in the forward's cases (f32: the 3xTF32
   tensor-core ``flash_bwd_dq_tf32``, ``flash_bwd_dkv_tf32``, whose
   library must hold TF32 ``HMMA`` instructions; bf16: the tensor-core
   ``flash_bwd_dq_mma``, ``flash_bwd_dkv_mma``), beside
   ``scaled_dot_product_attention``'s backward;
   gradients of single-GPU ``flash_attention`` against
   ``reference_attention``'s; five SGD steps of the training example
   (``models.long_context_training.main``, d_model 1024, 8 heads, d_ff
   2048, B 4, T 4096) on this card, its first gradients against the same
   step with ``reference_attention``; the same problem on four gloo ranks
   on a (2,2) grid of (dp, sp); and the gradients of causal and
   non-causal ring and causal Ulysses attention on four gloo ranks, each
   rank against its slice of single-GPU ``flash_attention``'s.
   TF32 is off in PyTorch: every f32 product of the plain versions and
   of cuBLAS is full f32; the f32 forward and backward kernels compute
   theirs by 3xTF32, which keeps f32 accuracy.
7. bf16 attention at the same width: single-GPU ``flash_attention`` on
   bf16 inputs, causal and not, forward alone and forward and backward,
   through the tensor-core kernels, its output and gradients against
   those of ``reference_attention`` on the same values in f32.
8. the op surface on four gloo ranks on this card: every op (the 13
   ops, the logical, bitwise and fold reductions, send/recv, barrier and
   four gradients) on f32, int32 and bool CUDA tensors, on the world
   comm and on an unequal color split, against numpy bit for bit (the
   f32 SUM and PROD allreduce on the world rtol 1e-5), each call's wall
   and staged bytes on rank 0; ``ring_attention(memory_efficient_grad=False)`` at the
   attention width (1024 tokens a rank), causal and not, forward and
   backward through ``sendrecv``'s transpose, each rank's output and
   gradients against its slice of single-GPU ``flash_attention``'s, the
   four f32 flash kernels' launches per rank checked, its backward's wall,
   exchange seconds and peak memory beside phase 6's memory-efficient
   backward; and ``entry.dryrun_multichip(4, device="cuda:0")``, whose
   ranks count the launches of its kernels (``sw_phase``, ``sw_wide`` and
   the four f32 flash kernels; the f32 flash ones checked per rank) and
   then hold each against its plain version at the shapes the dry run
   gave it (the stencils bit for bit, the flash partials and their
   backward in the ring's bands).  Four processes share one card, so no
   number of this phase is a scaling result.
9. data-parallel training and the throughput layer on four gloo ranks on
   this card: the DP example (``models.data_parallel_training.main``, 200
   steps at its own width) under fusion ``auto`` with the codecs off,
   bf16 and fp8 and under fusion ``off`` exact, each in lock-step on every
   rank, 1 exchange a step fused against 5, each codec's loss curve within
   ``PARITY_TOL`` of the exact run's after 10 steps, and 5 steps against
   single-device SGD on the concatenated batch; phase 6's (2,2) training
   under fusion ``off``, ``auto`` and ``force`` (6, 6 and 1 gradient
   collectives a step, the flash kernels' launches as phase 6's, the first
   gradients against ``off``'s in the f32 SUM band); the fusion demo's
   three forms (``models.fusion_overlap_demo.main``) and the gradient
   set's allreduces beside one f32 causal flash forward, start, compute,
   wait against allreduce then compute; and the fp8 and bf16 codec on
   CUDA tensors of the first gradients against the CPU, bit for bit.
   Four processes share one card: no number of this phase is a scaling
   result, and no codec shrinks the bytes an exchange moves here.
10. the dispatch layer on this card (``dispatch_phase``): the periodic
   and walled 0.1-day solves at 3600x1800 through
   ``solve_fused(fast="auto", unroll=N)`` for N in 1, 20 and 440, and the
   split-phase one (``fast="pallas_halo"``) for N = 20: the Euler step,
   then megastep calls that each replay one CUDA graph of N single steps
   (441 ``sw_steps``, 441 ``sw_wide`` and 882 ``sw_phase`` launches a
   run), each final state against ``pinned=True``'s (the whole-run graph)
   bit for bit, steps/s, graph replays and bytes copied per call, and the
   walled body's parts (frame build, kernel, crop) timed alone, and a
   ``torch.profiler`` trace of the 440 steps of three megastep runs
   (the device's busy share, its time by kernel); the test suite's
   generic step (an allreduce, then ``s*0.25 + v*0.5``) on a
   one-rank CUDA comm, ``compile(unroll=8)`` against 8 eager calls bit
   for bit, the host microseconds of a pinned call against an eager
   ``spmd`` call and a donated one, MPX129 when ``MPI4JAX_TPU_FUSION`` is
   set between calls and ``repin()``; and a capture made to fail (a host
   synchronisation in the body), which must raise.  One JSON line
   ``{"dispatch": ...}``.
11. the runtime services on this card (``runtime_phase``): the periodic
   and split-phase 0.1-day solves (``pinned=True``) under telemetry
   ``off``, ``counters`` and ``events``, each final state bit for bit with
   ``off``'s, the launches a run in every tier, the pin's graph kept under
   ``counters`` (``sendrecv`` counted per replay from the capture's stash)
   and run eagerly under ``events`` (every call journaled); the host
   microseconds a call of the generic step per service; four gloo ranks on
   (2,2) under off, counters, events and off again in the same four
   processes (a 0.02-day ``wide2`` solve, 91 steps, and 20 split-phase
   steps, bit for bit with ``off``, the events run's journals merged by
   the ``merge`` command); and, beside those four
   ranks, the drills of ``models/runtime_drill.py`` at 3600x1800 (delay,
   watchdog, corrupt, die), started together.  Each part's seconds are
   printed.  One JSON line ``{"runtime": ...}``.
12. the health plane on this card (``health_phase``): (a) the split-phase
   0.1-day solve (``pinned=True``) under ``counters`` with
   ``MPI4JAX_TPU_HEALTH`` off, on, on, off in this process, each final
   state bit for bit with the first's, 882 ``sw_phase`` launches a run, the
   pin still a graph, the flight ring's ``total`` the counted ``sendrecv``
   calls and its ``dropped`` that less its 1024 records; (b) the same under
   ``events`` (the pin eager), off and on: a begin and a record a call;
   (c) four gloo ranks on (2,2), 902x1802 a rank, 20 split-phase steps
   under ``events`` with the detector's ``on_boundary`` after every step:
   20 exchanges, the same cross-rank verdicts on every rank, a
   Prometheus file a rank, each exchange's ms on rank 0, then the same
   with rank 2 delayed 0.05 s in each ``sendrecv`` after its 300th and
   every rank's findings printed; (d) the ``health_hang`` and
   ``health_die`` drills, started together as (c) starts and running
   beside it: their postmortem bundles and
   the ``postmortem`` command naming the faulty rank; (e) in a process of
   its own, also beside (c), ``profile_ops``
   around one replay of a 20-step megastep graph (20 ``sw_steps`` kernels
   in the trace) and one eager split-phase step (its
   ``mpi4jax_tpu.sendrecv`` ranges and 2 ``sw_phase`` kernels); (f)
   ``prometheus_text()`` of (a) and ``cache_stats()``.  One JSON line
   ``{"health": ...}``.

13. elastic shrink-and-resume on four gloo ranks on this card
   (``elastic_phase``; it launches no kernel): (a) the example twin
   (``models/elastic_training.py``) at the JAX example's width, 12 steps,
   ``die:rank=3:op=allreduce:after=5`` with the claimed watchdog at 1 s:
   the survivors end at world 3, epoch 1, with identical parameters, bit
   for bit those of a clean 3-rank run from the committed state, and each
   survivor's detection, agreement, re-bootstrap, restore and first step
   at world 3 printed; (b) the ``hang`` drill (``hang:rank=2``, the same
   watchdog): recovery at world 3, no FATAL line, the hung rank killed;
   (c) the same loop at ``_init_params(dim=1024, hidden=8192)`` (8,404,993
   f32, 33.6 MB, the parameter bytes of phase 6's training block, the
   residual stack not committed), ``commit_every="auto"``, rank 3 dying in
   step 5 (``after=25``):
   the step, the commit (device to host and pack), the restore exchange
   over the 3 survivors and the interval ``auto`` locks in; (d)
   ``aot.compile_step(unroll=4)`` under ``elastic.run`` on four ranks,
   4 -> 3, eager pins (only megastep boundaries dispatched, a re-pin and a
   stale refusal), and on one rank, in a process of its own, a pin that
   is a CUDA graph, stale (MPX129) after ``advance_epoch()``, re-pinned
   as a graph; (e) a real SIGTERM to rank 3 after its step 5 at (c)'s
   width (``commit_every=4``): ranks 0-2 finish at world 3, epoch 1,
   cause ``drain``, rank 3 exits 0 drained, one ``drain`` incident a
   process, no watchdog expiry, no restore, and each survivor's seconds
   from the notice to its first step at world 3 by part (the forced
   commit, the leaver's ``notify_drain`` acks, the step between, the
   re-bootstrap); (f) ``preempt:rank=3`` on a (2,2) grid under
   ``MPI4JAX_TPU_ELASTIC_FAIL_UNIT=row``: ranks 2 and 3 drain, ranks 0
   and 1 finish on (1,2); (g) ``die:rank=3`` on the same grid, stripe
   placement over ``MPI4JAX_TPU_TOPOLOGY=2,2``: rank 2 shrunk out with
   rank 3, ranks 0 and 1 finish on (1,2); (h) ``--grow`` at (c)'s width,
   ``die:rank=3:op=allreduce:after=25``, ``commit_every="auto"``, 32
   steps, 4 -> 3 -> 4: the replacement (launch rank 4) completes the
   budget, the four final parameter sets are equal, the join's seconds by
   part (the poll, the admit, ``rebootstrap_grow``, the cold restore
   through one uint8 ``allreduce``), the joiner's wall from spawn to its
   first step, and a step at world 4 with the grow flag on beside (c)'s
   with it off.  (e), (f), (g) and (h) are each held bit for bit against a
   clean run of the world they end in, from the forced commit, the
   restore or the admission.  (a), (c), (e) and (h) run side by side;
   then (b), (d)'s two parts, (f), (g) and the clean run of (a)
   side by side; then the clean runs of (e), (h), (f) and (g); each
   part's seconds are printed as it ends.  (c), (e) and (h) step at lr 1e-3 (the example's
   0.05 diverges at that width) and their losses must be finite.  One
   JSON line ``{"elastic": ...}``.

14. the parallel workloads on four gloo ranks on this card
   (``workloads_phase``; no kernel of the table: the products are cuBLAS
   calls), in one launch: (a) the MoE twin (``models/moe_training.py``)
   at the JAX example's width (tokens 32, d 16, d_ff 32): the overlapped
   layer against the synchronous one bit for bit, and 4 SGD losses that
   decrease; (b) the MoE layer at d 1024, d_ff 2048, 4096 tokens a rank,
   4 experts at factor 1.25 (capacity 1280): each rank's output against
   the single-GPU fold of ``reference_moe``'s math on CUDA
   (``moe.fold_layer``) within rtol 1e-5, atol 1e-6 (bitwise or not,
   printed), chunks 2 and 4 against 1 bit for bit, the ms a layer (sync,
   chunks 2, chunks 4), a forward + backward, and rank 0's bytes staged
   and seconds in one layer's exchanges; (c) the pipeline twin
   (``models/pipeline_parallel.py``) at DIM 1024, 8 tanh substages (2 a
   rank), batch 512 in 16 microbatches of 32 rows: the ladder, gpipe,
   1f1b, interleaved (v=2) and auto, each bit for bit against the
   sequential single-GPU reference on the last rank, the ms a round, and
   under ``counters`` each schedule's measured bubble fraction beside its
   plan's ``(warmup + cooldown) / ticks``.  Four processes share one card:
   no number of this phase is a scaling result.  One JSON line
   ``{"workloads": ...}``.

15. the serving runtime (``serving_phase``; no kernel of the table: the
   decoder's products are cuBLAS calls): (a) the serve twin
   (``models/serving.py``) at its ``bench`` preset (d 1536, 24 heads of
   64, ffn 6144, max_len 160: 113.6 MB of f32 parameters, a 33.4 MB KV
   pool) on this card, its default trace (24 requests at 50/s, seed 7,
   long_frac 0.25, unroll 4, buckets 1, 2, 4, 8), one untimed pass that
   captures every program, then ``continuous`` and ``static`` on the wall
   clock: tokens/s/chip, p50, p99, TTFT p99 and the speedup, every
   request completed with its whole budget, every program a CUDA graph,
   and each bucket's decode megastep and prefill timed by CUDA events;
   (b) each request's greedy stream (virtual clock) under continuous
   unroll 4, static unroll 4 and continuous unroll 1 on the card and
   continuous unroll 4 on the CPU in this process, all equal, or each
   difference traced to its first token and the top-2 logit gap there (a
   gap inside the f32 band is recorded as a tie, one outside raises);
   (c) the drain drill on four gloo ranks, rank 3 preempted from boundary
   4 with sequences in flight, beside a clean four-rank run, the two
   launches side by side: every worker exits 0, one drains, the
   survivors finish at world 3 with every request and none failed, each
   survivor's ms from the notice to its first megastep at world 3 and its
   replay prefill, its streams against the clean run's (those finished
   before the drain bit for bit).  Four processes share one card: no
   number of (c) is a scaling result.  One JSON line ``{"serving": ...}``.
16. the persistent tier (``aot_phase``; it builds nothing): (a) the main
   build above runs with ``MPI4JAX_TPU_COMPILE_CACHE_DIR`` set to a fresh
   directory, which then holds the 7 kernel libraries and the host
   library (writes and bytes printed); (b) a fresh process with an empty
   build directory and that tier builds every kernel and the host
   library: 0 compiler invocations, 8 hits, 0 misses, its wall beside the
   main build's; each kernel launched once against its plain version (the
   stencils bit for bit at 3600x1800, the flash kernels in the bands of
   ``tests/test_kernels.py`` at B=4, T=4096); and a pinned ``sw_steps``
   pair (a CUDA graph) that reads the record this process wrote,
   ``from_disk``; (c) ``python -m mpi4jax_tpu_torch.aot warm
   --emit-manifest`` at the bench preset, world 1, then ``warm`` over it
   (exit 0, every program warmed), then a new process that serves the
   first request alone (its time to the first token) and the bench trace
   with ``disk_cache.misses == 0``, its 24 streams equal to phase 15
   (b)'s; (d) beside (c), ``models/aot_serving_step.py`` twice with one
   fresh directory, the second run ``from_disk`` with hits.  One JSON
   line ``{"aot": ...}``; the ``kernels`` line gives each kernel's
   difference after the reload.
17. the collective verifier (``verifier_phase``; it builds nothing and
   launches nothing of its own): (a) ``analyze(ranks="all")`` on a
   virtual 4-rank grid bound to this card, at the paths' full width: the
   (2,2) shallow-water first step and a pair at 3600x1800 global in
   ``wide2`` and ``pallas_halo``, the f32 ring-attention forward at B=4,
   T=4096, H=8, D=128, the MoE layer at d 1024, the interleaved pipeline
   at DIM 1024 and the serving bench preset's decode program at its
   largest bucket: 0 error findings each, its analysis time, and every
   kernel's launch counter unmoved; (b) the one-GPU pinned ``solve_fused``
   at 3600x1800, 0.1 day, under ``MPI4JAX_TPU_ANALYZE`` off, warn and
   error: final fields bit for bit, ``sw_steps`` launches equal, steps/s
   each and the first call's verification time; (c) ``python -m
   mpi4jax_tpu_torch.analysis --ranks 4 --json`` over each broken twin of
   ``models/broken/``, four processes at once: each exits 1 with its
   code; (d) ``rank_divergent_deadlock`` on four gloo ranks on this card
   under ``error`` with a 60 s limit: every rank raises ``AnalysisError``
   with MPX121 before any exchange.  One JSON line ``{"verifier": ...}``.
18. the cost model and the tuning layer (``cost_phase``; it builds
   nothing): (a) ``python -m mpi4jax_tpu_torch.autotune`` over four gloo
   ranks on this card (budget 30 s) and its rank function in this process
   as one CUDA rank (budget 20 s):
   the fitted alpha, beta and gamma, the compute rate, the dispatch, the
   pack GB/s, the bucket and the chunks, the seconds and the exit code
   (1: one host without a topology leaves the alltoall crossover
   untuned), each file
   validated by ``validate_tuning_dict``; (b) ``analyze(cost=True,
   ranks="all")`` with the four-rank file over phase 17 (a)'s programs
   and the bench decode on a one-rank grid: each program's predicted
   step, its compute and wire split, its advisories and seconds, 0 error
   findings, no launch counter moved, and beside the measurement of this
   run for the (2,2) ``wide2`` step (phase 4), the MoE layer (phase 14
   (b)), the interleaved round (phase 14 (c)) and the decode (phase 15),
   the ratio with no bound; (c) the pinned periodic solve at 3600x1800
   with the file loaded under ``off`` and under ``MPI4JAX_TPU_ANALYZE=
   error`` + ``MPI4JAX_TPU_ANALYZE_COST=on``: steps/s each, final fields
   bit for bit, ``sw_steps`` launches equal, the verification and its
   prediction; (d) ``ef_divergent_gate`` through the command (phase 17
   (c)) exits 1 with MPX141, the earlier twins exit 1, and on four gloo
   ranks under ``error`` every rank raises MPX141 before any exchange;
   (e) ``pipeline(schedule="auto")`` at phase 14 (c)'s shape picks what
   ``best_schedule`` prices best under the file, and the serve twin's
   ``--simulate`` at the bench preset prints its predicted tokens/s/chip
   and p99 beside phase 15's.  One JSON line ``{"cost": ...}``.
19. the collective algorithm layer (``hierarchy_phase``; it builds
   nothing): four gloo ranks on this card under
   ``MPI4JAX_TPU_TOPOLOGY=2x2`` (two faked hosts of two ranks), and the
   same cases on four CPU ranks beside them: (a) the
   ``hierarchical_demo`` twin (its plan must be (2, 2)); (b) allreduce
   SUM, PROD, MAX, int32 BXOR and an elementwise callable, SUM on a
   parity split, reduce_scatter and bcast from roots 0 and 3, each under
   butterfly, ring and hier at the (2,2) training cell's gradient bytes
   (33.6 MB f32) and 64 KiB below the ring crossover, with the native
   SUM beside; the hierarchical SUM under the codecs off, bf16 and fp8;
   per call the ms, exchanges, staged bytes and the counters' modeled
   intra, inter and wire inter bytes; (c) every result of (b) bit for bit
   with the CPU's (sha256 of the bytes; the native SUM is timed only),
   the exact ones equal across the lowerings, and no forced ``hier``
   fallen back; (d) the MoE layer of phase 14 (b) under ``auto`` (the
   hierarchical alltoall) against flat, bit for bit, ms a layer and its
   link split; (e) ``autotune(budget_s=20, topologies=("2x2",))``.  One
   JSON line ``{"hierarchy": ...}``; faked hosts on one card, so no
   number is a hierarchy's gain.

It exits non-zero, and prints no result, without a CUDA device or outside
a checkout of the repository.  Every phase raises on failure.

    python3 chip_smoke.py --stencils

builds only the stencil sources and runs their phases: the kernels
against their plain versions, their times and geometry, the three
single-GPU solves and the digests of their machine code
(``stencils_main``), one JSON line.

    python3 chip_smoke.py --bwd-digest

builds only the two backward sources and prints the sha256 of their
machine code and of their gradients on fixed inputs (``backward_digests``):
run from two checkouts on one card, equal digests say that their
backward kernels are the same.

    python3 chip_smoke.py --dispatch

builds only the stencil sources and runs phase 10 alone
(``dispatch_main``), one JSON line.

    python3 chip_smoke.py --ring

builds only the f32 forward source and times phase 6's four-rank ring
forward, causal and not, eight calls each (``ring_main``), one JSON line:
run from two checkouts in one call, it sets their ring forwards side by
side.

    python3 chip_smoke.py --runtime
    python3 chip_smoke.py --health

build the stencil sources and the host library and run phase 11 or phase
12 alone, one JSON line each.

    python3 chip_smoke.py --elastic
    python3 chip_smoke.py --workloads
    python3 chip_smoke.py --serving

run phase 13, 14 or 15 alone (nothing to build), one JSON line each.

    python3 chip_smoke.py --aot

builds every kernel through a fresh tier, takes phase 15 (b)'s
continuous streams in this process, and runs phase 16, one JSON line.

    python3 chip_smoke.py --verifier

builds the stencil sources (phase 17 (b) runs the main path) and runs
phase 17 alone, one JSON line.
    python3 chip_smoke.py --cost

builds the stencil source and runs phase 18 alone (``cost_main``; its
predictions stand alone, with nothing of this run measured beside them),
one JSON line.

    python3 chip_smoke.py --hierarchy

runs phase 19 alone (nothing to build), one JSON line.
"""

import contextlib
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
# outside the tensor cores, dense bf16 and TF32 FLOP/s of the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12
PEAK_TF32_PER_S = 494.7e12
# f32 operations per cell and step of csrc/sw_steps.cu, counted from its
# source (a division counts as one)
OPS_PER_CELL_STEP = 107
# f32 operations per cell of the split-phase kernels' two phases, counted
# from csrc/sw_phase.cu and the stage physics of csrc/sw_stream.cuh it
# calls (phase 1: fluxes 30, tendencies 36, advance 15 for AB-2; phase 2:
# visc_fluxes 6 and viscous 7 per field); a wide step is both
OPS_PER_CELL_PHASE = {1: 81, 2: 26}
# the states the stencil kernels are timed on a second time: after this
# many steps of the 0.1-day run, halfway (a stencil's time depends on its
# data, and the first step's state is mostly at rest)
LATE_STEP = 221
# the parity band of the JAX suite for the fused kernel against
# model_step_fast (tests/test_examples.py): reordered-arithmetic rounding
BAND_ABS, BAND_REL = 5e-6, 1e-6
# the band for a whole 0.1-day run against another path's
# (tests/test_examples.py:337, the carried-frame run's)
RUN_BAND_ABS, RUN_BAND_REL = 1e-5, 2e-6
# the width the JAX package built and measured its flash kernel at
# (mpi4jax_tpu/kernels/flash_attention.py:33)
ATTN_B, ATTN_T, ATTN_H, ATTN_D = 4, 4096, 8, 128
# flash kernel against plain, per field against max|ref| (tests/
# test_kernels.py:50-55, :206-211): m 1e-6, l and o 1e-5 (+ the same
# absolute), the causal kernel's o 1e-4; bf16 o 4 * 2^-8 of max|ref|
FLASH_REL = {"m": 1e-6, "l": 1e-5, "o": 1e-5}
FLASH_CAUSAL_O_REL = 1e-4
FLASH_BF16_O_REL = 4 * 2.0**-8
# attention outputs against another path (tests/test_long_context.py:61)
ATTN_RTOL, ATTN_ATOL = 2e-4, 2e-5
# backward kernels against plain, per gradient against max|ref|
# (tests/test_kernels.py:252, rtol 1e-3, atol 1e-4); bf16 4 * 2^-8
BWD_REL, BWD_ABS = 1e-3, 1e-4
# attention gradients against another path (tests/test_long_context.py:128)
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4
# the training example at the attention width (d_model = heads * D,
# d_ff = 2 d_model, examples/long_context_training.py:119); SGD at the
# example's lr 0.1 diverges at this width, 1e-3 does not
TRAIN = {"b_loc": ATTN_B, "t_loc": ATTN_T, "d_model": ATTN_H * ATTN_D,
         "d_ff": 2 * ATTN_H * ATTN_D, "heads": ATTN_H, "steps": 5, "lr": 1e-3,
         "seed": 0}
# the first step against single-device attention (tests/test_examples.py:
# 563-569): loss rtol 1e-5, gradients rtol 2e-3, atol 2e-5
LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL = 1e-5, 2e-3, 2e-5


def band(ref):
    return BAND_ABS + BAND_REL * ref.abs().max().item()


def time_ms(fn, reps, warmup):
    """Mean device time of one call, from CUDA events around ``reps``
    calls after ``warmup`` calls (enough of them to bring the clocks up)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_graph_ms(fn, reps, warmup):
    """Mean device time of one call, from CUDA events around one replay of
    a CUDA graph that holds ``reps`` calls (after ``warmup`` calls): no host
    time between the launches, which the wrapper of a kernel that runs for
    tens of microseconds would otherwise add."""
    for _ in range(warmup):
        fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, ref_fields, out_fields, names, exact=False):
    """Largest absolute difference over the fields; raises outside the
    band, or, ``exact``, unless every field equals the plain version's bit
    for bit, the signs of zeros included (the stencil kernels against their
    plain versions)."""
    worst = 0.0
    for fname, a, b in zip(names, ref_fields, out_fields):
        if not bool(torch.isfinite(b).all()):
            raise AssertionError(f"{name}: field {fname} is not finite")
        err = (a - b).abs().max().item()
        if exact:
            same = torch.equal(a.contiguous().view(torch.int32),
                               b.contiguous().view(torch.int32))
            print(f"  {name} {fname}: max|diff| {err:.3e} (bit for bit: {same})")
            if not same:
                raise AssertionError(f"{name}: field {fname} differs from plain "
                                     f"(max|diff| {err:.3e})")
        else:
            lim = band(a)
            print(f"  {name} {fname}: max|diff| {err:.3e} (band {lim:.3e})")
            if err > lim:
                raise AssertionError(f"{name}: field {fname} off by {err:.3e} > {lim:.3e}")
        worst = max(worst, err)
    return worst


def bound_ms(bytes_moved, ops, peak=PEAK_F32_PER_S):
    """The least time for a call: bytes over the HBM rate or operations
    over ``peak`` (the f32 rate unless given), whichever is longer; and
    which one it is."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_need(cfg, phase):
    """Bytes and f32 operations one AB-2 sw_phase call needs.  The halo
    ring of its output is not: the next enforce_boundaries overwrites it in
    h, u and v, and the tendencies' ring feeds only ring cells.  So phase 1
    reads h, u, v whole (read at neighbours) and dh, du, dv on the interior
    (read at the output cell), and writes six fields on the interior;
    phase 2 reads u, v whole and writes them on the interior."""
    ny, nx = cfg.ny_local, cfg.nx_local
    cells, interior = ny * nx, (ny - 2) * (nx - 2)
    if phase == 1:
        moved = 3 * cells + 3 * interior + 6 * interior
    else:
        moved = 2 * cells + 2 * interior
    return 4 * moved, OPS_PER_CELL_PHASE[phase] * interior


def wide_need(cfg, nsteps, radius):
    """Bytes and f32 operations one AB-2 sw_wide call of ``nsteps`` steps
    needs.  Only the crop region of its output is meaningful (the caller
    refreshes every margin cell before the next call), so with ``radius``
    the per-step dependency radius, step s computes on the crop grown by
    (nsteps - s) x radius; h, u, v are read on the crop grown by nsteps x
    radius, dh, du, dv where step 1 computes, and six fields are written
    on the crop."""
    def cells(k):
        return ((cfg.ny_local + 2 * k * radius[0])
                * (cfg.nx_local + 2 * k * radius[1]))
    moved = 3 * cells(nsteps) + 3 * cells(nsteps - 1) + 6 * cells(0)
    step_ops = OPS_PER_CELL_PHASE[1] + OPS_PER_CELL_PHASE[2]
    return 4 * moved, step_ops * sum(cells(nsteps - s) for s in range(1, nsteps + 1))


def timed_case(label, kernel, plain, bytes_moved, ops, peak=PEAK_F32_PER_S,
               reps=50, graph=False):
    """Kernel and plain times of one call and its bound, printed; with
    ``graph`` the kernel's calls are timed from a CUDA graph."""
    ms = (time_graph_ms if graph else time_ms)(kernel, reps=reps, warmup=reps)
    plain_ms = time_ms(plain, reps=5, warmup=2)
    bms, by = bound_ms(bytes_moved, ops, peak)
    rate = (f"{ops / ms / 1e9:.1f} TFLOP/s" if by == "operations"
            else f"{bytes_moved / ms / 1e6:.1f} GB/s")
    print(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bms:.4f} ms ({by}; {rate} achieved)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}


def phase_frames(P, dev):
    """The frames sw_phase is held and timed on: the 1802x3602 local arrays
    of 3600x1800, periodic and walled, at offsets (0, 0), and ranks 0 and 3
    of its (2,2) grid (902x1802 at (0, 0) and (900, 1800)); for each, its
    config, offsets, initial state and its state after ``LATE_STEP`` steps
    of the plain ``fast=True`` path (on the (2,2) ranks, cut from the
    periodic single-rank state: the same domain)."""
    g4 = P.Config(nx=3600, ny=1800, nproc_y=2, nproc_x=2)
    frames, late = {}, {}
    for label, cfg in (("periodic", P.Config(nx=3600, ny=1800)),
                       ("walled", P.Config(nx=3600, ny=1800, periodic_x=False))):
        _, comm = P.make_mesh_and_comm(cfg, device=dev)
        first, multi = P.make_stepper(cfg, comm, fast=True)
        late[label] = tuple(multi(first(P.initial_state(cfg, device=dev)), LATE_STEP - 1))
        frames[label] = (cfg, (0, 0), tuple(P.initial_state(cfg, device=dev)), late[label])
    for rank in (0, 3):
        py, px = divmod(rank, g4.nproc_x)
        oy, ox = py * (g4.ny_local - 2), px * (g4.nx_local - 2)
        cut = tuple(f[oy:oy + g4.ny_local, ox:ox + g4.nx_local].contiguous()
                    for f in late["periodic"])
        frames[f"2x2 rank {rank}"] = (g4, (oy, ox),
                                      tuple(P.initial_state(g4, rank=rank, device=dev)), cut)
    return frames


def check_phase_kernels(P, KP, dev, names):
    """sw_phase against its plain version at full width, bit for bit (int32
    views): Euler and AB-2 phase 1 and phase 2 on each of ``phase_frames``,
    on its first AB-2 state and on its state at ``LATE_STEP``; both phases
    timed on both, from CUDA graphs (a (2,2) rank's call lasts about as long
    as its wrapper's host time)."""
    worst, per_case = 0.0, {}
    for label, (cfg, off, s0, late) in phase_frames(P, dev).items():
        s1 = KP.sw_phase1_plain(s0, cfg, True, off)  # AB-2 inputs from here
        for first, inp, at in ((True, s0, ""), (False, s1, ""),
                               (False, late, f", step {LATE_STEP}")):
            ref = KP.sw_phase1_plain(inp, cfg, first, off)
            out = KP.sw_phase1(inp, cfg, first, off)
            worst = max(worst, compare(f"sw_phase1({label}, first={first}{at})",
                                       ref, out, names, exact=True))
        for inp, at in ((s1, ""), (late, f", step {LATE_STEP}")):
            ref = KP.sw_phase2_plain(inp[1], inp[2], cfg, off)
            out = KP.sw_phase2(inp[1], inp[2], cfg, off)
            worst = max(worst, compare(f"sw_phase2({label}{at})", ref, out, ("u", "v"),
                                       exact=True))
        for inp, key in ((s1, ""), (late, f",step={LATE_STEP}")):
            per_case[f"{label},phase1{key}"] = timed_case(
                f"sw_phase1({label}{key})",
                lambda: KP.sw_phase1(inp, cfg, False, off),
                lambda: KP.sw_phase1_plain(inp, cfg, False, off),
                *phase_need(cfg, 1), graph=True)
            per_case[f"{label},phase2{key}"] = timed_case(
                f"sw_phase2({label}{key})",
                lambda: KP.sw_phase2(inp[1], inp[2], cfg, off),
                lambda: KP.sw_phase2_plain(inp[1], inp[2], cfg, off),
                *phase_need(cfg, 2), graph=True)
    return worst, per_case


def rank_frames(P, dev, cfg, m, ranks):
    """The widened frames of ``ranks`` of ``cfg`` (a grid of ranks of
    3600x1800, periodic in x) and their domain-global offsets, cut from one
    global array grown by ``m - 1`` cells on every side: the whole
    domain's initial state, its interior columns repeated periodically in
    x, zeros beyond the walls (as ``_wide_exchange`` leaves them)."""
    e = m - 1
    whole = P.initial_state(P.Config(nx=cfg.nx, ny=cfg.ny), device=dev)
    cols = (torch.arange(-e, cfg.nx + 2 + e, device=dev) - 1) % cfg.nx + 1
    glob = []
    for f in whole:
        f = f[:, cols]
        pad = torch.zeros(e, f.shape[1], dtype=f.dtype, device=dev)
        glob.append(torch.cat([pad, f, pad]))
    ny_w, nx_w = cfg.ny_local + 2 * e, cfg.nx_local + 2 * e
    out = {}
    for rank in ranks:
        py, px = divmod(rank, cfg.nproc_x)
        oy, ox = py * (cfg.ny_local - 2), px * (cfg.nx_local - 2)
        out[rank] = (tuple(g[oy:oy + ny_w, ox:ox + nx_w].contiguous() for g in glob),
                     (oy - e, ox - e))
    return out


def check_wide_kernel(P, KW, dev, names):
    """sw_wide against its plain version on the crop region, bit for bit:
    the walled (1,1) widened frame of 3600x1800 (1832x3632) and the
    periodic frames of ranks 0 and 3 of its (2,2) grid (932x1832, at the
    ranks' offsets), Euler and AB-2, one and two steps."""
    cfg = P.Config(nx=3600, ny=1800, periodic_x=False)
    _, comm = P.make_mesh_and_comm(cfg, device=dev)
    m = P._margin_rows(2)
    wf, _ = P._wide_exchange(tuple(P.initial_state(cfg, device=dev)), cfg, comm,
                             m, P.create_token())
    off = (-(m - 1), -(m - 1))
    g4 = P.Config(nx=3600, ny=1800, nproc_y=2, nproc_x=2)
    cases = [("walled", cfg, wf, off)]
    for rank, (frame, roff) in rank_frames(P, dev, g4, m, (0, 3)).items():
        cases.append((f"(2,2) rank {rank}", g4, frame, roff))
    worst, per_case = 0.0, {}
    for where, c, frame, o in cases:
        sl = (slice(m - 1, m - 1 + c.ny_local), slice(m - 1, m - 1 + c.nx_local))
        frame1 = KW.sw_wide_plain(frame, c, True, 1, o)  # AB-2 inputs from here
        for first, nsteps, inp in ((True, 1, frame), (True, 2, frame), (False, 1, frame1),
                                   (False, 2, frame1)):
            ref = KW.sw_wide_plain(inp, c, first, nsteps, o)
            out = KW.sw_wide(inp, c, first, nsteps, o)
            label = f"sw_wide({where}, first={first}, nsteps={nsteps})"
            worst = max(worst, compare(label, [a[sl] for a in ref],
                                       [b[sl] for b in out], names, exact=True))
            if not first and where != "(2,2) rank 3":
                key = f"nsteps={nsteps}" if where == "walled" else f"{where},nsteps={nsteps}"
                per_case[key] = timed_case(
                    label,
                    lambda: KW.sw_wide(inp, c, False, nsteps, o),
                    lambda: KW.sw_wide_plain(inp, c, False, nsteps, o),
                    *wide_need(c, nsteps, KW.STEP_RADIUS))
        print(f"  widened frame {where} {tuple(frame[0].shape)} at offsets {o}")
    return worst, per_case


def check_steps_kernel(P, K, dev, names):
    """sw_steps against its plain version on the 1802x3602 local arrays of
    3600x1800, bit for bit, every (first step, nsteps) the main path and
    the fused modes take, each timed beside its plain version."""
    cfg = P.Config(nx=3600, ny=1800)
    cells = cfg.ny_local * cfg.nx_local
    s0 = tuple(P.initial_state(cfg, device=dev))
    s1 = K.sw_steps_plain(s0, cfg, True, 1)  # AB-2 steps start from here
    per_case = {}
    worst = 0.0
    for first, nsteps in ((True, 1), (False, 1), (False, 2), (False, 3)):
        inp = s0 if first else s1
        ref = K.sw_steps_plain(inp, cfg, first, nsteps)
        out = K.sw_steps(inp, cfg, first, nsteps)
        torch.cuda.synchronize()
        label = f"sw_steps(first={first}, nsteps={nsteps})"
        worst = max(worst, compare(label, ref, out, names, exact=True))
        per_case[f"first={first},nsteps={nsteps}"] = timed_case(
            label,
            lambda: K.sw_steps(inp, cfg, first, nsteps),
            lambda: K.sw_steps_plain(inp, cfg, first, nsteps),
            12 * cells * 4, OPS_PER_CELL_STEP * nsteps * cells)
    # the pair again on the state halfway through the main path's run:
    # the kernel's time depends on the data (a division with a zero or
    # tiny operand takes a slow path), and the first step's state is
    # mostly at rest
    mid = s1
    for _ in range(110):
        mid = K.sw_steps(mid, cfg, False, 2)
    ref = K.sw_steps_plain(mid, cfg, False, 2)
    out = K.sw_steps(mid, cfg, False, 2)
    label = "sw_steps(first=False, nsteps=2) at step 221"
    worst = max(worst, compare(label, ref, out, names, exact=True))
    per_case["first=False,nsteps=2,step=221"] = timed_case(
        label, lambda: K.sw_steps(mid, cfg, False, 2),
        lambda: K.sw_steps_plain(mid, cfg, False, 2),
        12 * cells * 4, OPS_PER_CELL_STEP * 2 * cells)
    return worst, per_case


def stencil_geometry(K, KW, KP, P):
    """Each stencil kernel's blocks at the shapes of its paths, from the
    geometry functions its source exports: blocks resident per SM (from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the cells it
    computes per step over those it keeps.  Without the kernels of a
    checkout whose sources export none (before the streamed designs)."""
    if not hasattr(K, "geometry"):
        return {}
    wcfg = P.Config(nx=3600, ny=1800, periodic_x=False)
    g4 = P.Config(nx=3600, ny=1800, nproc_y=2, nproc_x=2)
    geo = {}
    for nsteps in (1, 2, 3):
        geo[f"sw_steps,nsteps={nsteps}"] = K.geometry((1802, 3602), nsteps)
    for nsteps in (1, 2):
        geo[f"sw_wide,nsteps={nsteps}"] = KW.geometry(wcfg, (1832, 3632), nsteps)
    geo["sw_wide,nsteps=2,(2,2) rank"] = KW.geometry(g4, (932, 1832), 2)
    for phase in (1, 2) if hasattr(KP, "geometry") else ():
        geo[f"sw_phase,phase={phase}"] = KP.geometry((1802, 3602), phase)
        geo[f"sw_phase,phase={phase},(2,2) rank"] = KP.geometry((902, 1802), phase)
    for name, g in geo.items():
        print(f"  geometry {name}: {g['strips']} strips x {g['chunks']} chunks of "
              f"{g['rows_per_block']} rows, {g['blocks_per_sm']} blocks "
              f"({g['warps_per_sm']} warps) resident per SM, {g['smem_bytes']} B of "
              f"shared memory a block, computed/useful cells "
              f"{g['computed_per_useful']:.4f}")
    return geo


def periodic_solve(P, K, dev, t1):
    """The main path: ``solve_fused(fast="auto", pinned=True)`` at 3600x1800
    periodic to ``t1`` (one CUDA graph), its launches and final state
    checked, then 20 steps of the kernel path against the plain
    ``fast=True`` path."""
    cfg = P.Config(nx=3600, ny=1800)
    ny, nx = cfg.ny_local, cfg.nx_local
    _, comm = P.make_mesh_and_comm(cfg, device=dev)
    names = P.State._fields
    info = {}
    K.counter.launches = 0
    wall, n_steps, final = P.solve_fused(cfg, t1, device=dev, fast="auto",
                                         pinned=True, return_state=True, info=info)
    launches = K.counter.launches
    per_run = 1 + (n_steps - 1) // 2  # the Euler call and the pair calls
    print(f"main path: {n_steps} steps, wall {wall:.4f} s, "
          f"{n_steps / wall:.2f} steps/s, state traffic "
          f"{12 * ny * nx * 4 * n_steps / wall / 1e9:.1f} GB/s, "
          f"{info['runs']} runs, sw_steps launches {launches}")
    if n_steps != 441 or (n_steps - 1) % 2:
        raise AssertionError(f"expected 441 steps, got {n_steps}")
    if launches != per_run * info["runs"] or launches == 0:
        raise AssertionError(
            f"sw_steps launched {launches} times, expected "
            f"{per_run} x {info['runs']} runs"
        )
    h = final.h
    if tuple(h.shape) != (ny, nx) or not bool(torch.isfinite(h).all()):
        raise AssertionError("final h is not finite at the expected shape")
    for f in final:
        if not bool(torch.isfinite(f).all()):
            raise AssertionError("final state is not finite")
    mean_h = h[1:-1, 1:-1].mean().item()
    print(f"  final h: mean {mean_h:.4f} (depth {cfg.depth}), "
          f"min {h.min().item():.4f}, max {h.max().item():.4f}")
    if not abs(mean_h - cfg.depth) < 10:
        raise AssertionError(f"mean height {mean_h} far from depth {cfg.depth}")
    # the pair's time on the state the main path ends with (a kernel's
    # time depends on its data)
    final_pair_ms = time_ms(lambda: K.sw_steps(tuple(final), cfg, False, 2), reps=50,
                            warmup=50)
    print(f"  sw_steps pair on the final state: {final_pair_ms:.4f} ms")
    # kept on the host for the four-rank run's comparison
    single_final = [f[1:-1, 1:-1].cpu() for f in final]
    del final, h

    # the kernel path against the plain fast=True path over 20 steps
    s = P.initial_state(cfg, device=dev)
    first_k, multi_k = P.make_stepper(cfg, comm, fast="pallas2")
    first_p, multi_p = P.make_stepper(cfg, comm, fast=True)
    out_k = multi_k(first_k(s), 19)
    out_p = multi_p(first_p(s), 19)
    torch.cuda.synchronize()
    worst20 = compare("20 steps pallas2 vs fast", out_p, out_k, names)
    return {"steps": n_steps, "wall": wall, "steps_per_s": n_steps / wall,
            "runs": info["runs"], "launches": launches, "worst20": worst20,
            "final_pair_ms": final_pair_ms, "final": single_final}


def walled_solve(P, KW, dev, t1):
    """The single-GPU walled solve: "auto" picks the wide-halo pair kernel;
    its launches and final state checked, then 20 steps of ``wide2``
    against the plain ``fast=True`` path."""
    wcfg = P.Config(nx=3600, ny=1800, periodic_x=False)
    names = P.State._fields
    if P.select_steps("auto", wcfg)[1] is not P.model_step2_wide:
        raise AssertionError("auto does not pick wide2 on the walled config")
    winfo = {}
    KW.counter.launches = 0
    wwall, wn, wfinal = P.solve_fused(wcfg, t1, device=dev, fast="auto",
                                      pinned=True, return_state=True, info=winfo)
    wide_launches = KW.counter.launches
    print(f"walled path: {wn} steps, wall {wwall:.4f} s, {wn / wwall:.2f} steps/s, "
          f"{winfo['runs']} runs, sw_wide launches {wide_launches}")
    if wide_launches != 221 * winfo["runs"]:
        raise AssertionError(
            f"sw_wide launched {wide_launches} times, expected 221 x {winfo['runs']}")
    for f in wfinal:
        if not bool(torch.isfinite(f).all()):
            raise AssertionError("walled final state is not finite")
    wmean = wfinal.h[1:-1, 1:-1].mean().item()
    if not abs(wmean - wcfg.depth) < 10:
        raise AssertionError(f"walled mean height {wmean} far from depth")
    del wfinal
    _, wcomm = P.make_mesh_and_comm(wcfg, device=dev)
    s = P.initial_state(wcfg, device=dev)
    first_w, multi_w = P.make_stepper(wcfg, wcomm, fast="wide2")
    first_p, multi_p = P.make_stepper(wcfg, wcomm, fast=True)
    out_w = multi_w(first_w(s), 19)
    out_p = multi_p(first_p(s), 19)
    torch.cuda.synchronize()
    worst20 = compare("20 steps wide2 vs fast (walled)", out_p, out_w, names)
    return {"steps": wn, "wall": wwall, "steps_per_s": wn / wwall,
            "runs": winfo["runs"], "launches": wide_launches, "worst20": worst20}


def halo_solve(P, KP, dev, t1):
    """The split-phase path on one GPU: ``solve_fused(fast="pallas_halo",
    pinned=True)`` at 3600x1800 periodic to ``t1`` (one CUDA graph; the
    single rank's exchanges are copies onto itself), its launches counted
    (two a step), its final state against the plain ``fast=True`` path's
    over the same steps on the card, bit for bit: on one rank the two run
    the same operations in the same order, and the kernel equals its plain
    version bit for bit."""
    cfg = P.Config(nx=3600, ny=1800)
    info = {}
    KP.counter.launches = 0
    wall, n_steps, final = P.solve_fused(cfg, t1, device=dev, fast="pallas_halo",
                                         pinned=True, return_state=True, info=info)
    launches = KP.counter.launches
    per_run = 2 * n_steps
    print(f"split-phase path (pallas_halo, 1 GPU): {n_steps} steps, wall {wall:.4f} s, "
          f"{n_steps / wall:.2f} steps/s, {info['runs']} runs, sw_phase launches "
          f"{launches} ({per_run} a run)")
    if n_steps != 441 or launches != per_run * info["runs"]:
        raise AssertionError(f"sw_phase launched {launches} times in {info['runs']} runs "
                             f"of {n_steps} steps, expected {per_run} a run")
    _, comm = P.make_mesh_and_comm(cfg, device=dev)
    first, multi = P.make_stepper(cfg, comm, fast=True)
    ref = multi(first(P.initial_state(cfg, device=dev)), n_steps - 1)
    worst = compare("pallas_halo vs fast=True, 0.1 day", ref, final, P.State._fields,
                    exact=True)
    return {"steps": n_steps, "wall": wall, "steps_per_s": n_steps / wall,
            "runs": info["runs"], "launches": launches, "launches_per_run": per_run,
            "pinned": info["pinned"], "max_abs_err": worst}


def stencils_main():
    """``python3 chip_smoke.py --stencils``: builds the stencil sources of
    the checkout that holds this script and runs only their phases: each
    stencil kernel against its plain version at full width, bit for bit,
    timed, with its geometry, the periodic, walled and split-phase 0.1-day
    solves, and the sha256 of each source's machine code; one JSON line.
    Run from two checkouts in one call, it sets their stencil times and
    steps/s side by side."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    from mpi4jax_tpu_torch.kernels import _build
    from mpi4jax_tpu_torch.kernels import sw_phase as KP
    from mpi4jax_tpu_torch.kernels import sw_steps as K
    from mpi4jax_tpu_torch.kernels import sw_wide as KW
    from mpi4jax_tpu_torch.models import shallow_water as P

    t0 = time.perf_counter()
    libs = _build.build_many([K.spec(), KP.spec(), KW.spec()])
    print(f"built the stencil sources in {time.perf_counter() - t0:.1f} s")
    sass = {name: sass_digest(lib, _build._nvcc())
            for name, lib in zip(("sw_steps", "sw_phase", "sw_wide"), libs)}
    print("machine code sha256:", json.dumps(sass))
    census = sass_census(libs[1], _build._nvcc())
    print("sw_phase machine code, instructions by kind:", json.dumps(census))
    print_stencil_ptxas(_build)
    dev = torch.device("cuda")
    names = P.State._fields
    geo = stencil_geometry(K, KW, KP, P)
    worst, per_case = check_steps_kernel(P, K, dev, names)
    phase_worst, phase_cases = check_phase_kernels(P, KP, dev, names)
    wide_worst, wide_cases = check_wide_kernel(P, KW, dev, names)
    t1 = 0.1 * P.DAY_IN_SECONDS
    periodic = periodic_solve(P, K, dev, t1)
    periodic.pop("final")
    walled = walled_solve(P, KW, dev, t1)
    halo = halo_solve(P, KP, dev, t1)
    print(smi)
    print(json.dumps({"stencils": {
        "sw_steps": per_case, "sw_phase": phase_cases, "sw_wide": wide_cases,
        "max_abs_err": {"sw_steps": worst, "sw_phase": phase_worst, "sw_wide": wide_worst},
        "geometry": geo, "periodic_solve": periodic, "walled_solve": walled,
        "halo_solve": halo, "sass_sha256": sass, "sw_phase_sass_census": census}}))
    return 0


# phase 10: the megastep trip counts of the periodic and walled solves, and
# the split-phase solve's
UNROLLS = (1, 20, 440)
HALO_UNROLL = 20
# the generic step's megastep and its per-call timing
GENERIC_UNROLL, GENERIC_SHAPE, GENERIC_CALLS = 8, (8, 256), 2000


def megastep_solves(P, name, label, cfg, fast, dev, t1, unrolls, per_step):
    """``solve_fused(fast=fast, unroll=N)`` for each N beside
    ``pinned=True`` in this process: each final state bit for bit with the
    whole-run graph's, ``per_step`` launches of kernel ``name`` a step (the
    Euler step and N-step graph replays), the replays a run and the bytes a
    call copies; launch counts set to 0 just before each solve and read
    just after."""
    from mpi4jax_tpu_torch.kernels import _build

    counter = _build.counter_for(name)
    info = {}
    wall, n, ref = P.solve_fused(cfg, t1, device=dev, fast=fast, pinned=True,
                                 return_state=True, info=info)
    out = {"pinned": {"steps": n, "wall": wall, "steps_per_s": n / wall}}
    print(f"{label}: pinned=True (whole-run graph) {n / wall:.2f} steps/s")
    for N in unrolls:
        info = {}
        counter.launches = 0
        wall, n, final = P.solve_fused(cfg, t1, device=dev, fast=fast, unroll=N,
                                       return_state=True, info=info)
        launches = counter.launches
        n_mega, tail = divmod(n - 1, N)
        replays = n_mega + (1 if tail else 0)
        per_run = per_step * n
        # the pins ran their bodies once eagerly before each capture
        warm = per_step * ((N if n_mega else 0) + tail)
        print(f"{label}, unroll={N}: {n / wall:.2f} steps/s, {info['replays']} graph "
              f"replays and {info['launches'].get(name, 0)} {name} launches a run "
              f"({launches} over {info['runs']} runs and the pins' warm-ups), "
              f"{info['bytes_copied'] / max(1, info['replays']):.0f} bytes copied "
              "a call")
        if not (info["unroll"] == N and info["pinned"]):
            raise AssertionError(f"{label}, unroll={N}: no graph megastep ran ({info})")
        if info["launches"].get(name) != per_run or info["replays"] != replays:
            raise AssertionError(
                f"{label}, unroll={N}: {info['launches']} launches and "
                f"{info['replays']} replays a run, expected {per_run} {name} and "
                f"{replays}")
        if launches != per_run * info["runs"] + warm:
            raise AssertionError(f"{label}, unroll={N}: {name} launched {launches} "
                                 f"times, expected {per_run} x {info['runs']} + {warm}")
        compare(f"{label}, unroll={N} vs pinned=True", ref, final, P.State._fields,
                exact=True)
        out[f"unroll={N}"] = {
            "steps": n, "wall": wall, "steps_per_s": n / wall,
            "replays_per_run": info["replays"], "launches_per_run": per_run,
            "launches": launches, "runs": info["runs"],
            "bytes_copied_per_call": info["bytes_copied"] / max(1, info["replays"]),
            "bit_for_bit_with_pinned": True}
        del final
        torch.cuda.empty_cache()
    del ref
    torch.cuda.empty_cache()
    return out


def walled_step_parts(P, dev):
    """The walled megastep's body, one step at full width, by part, each
    timed from a CUDA graph of 20 calls: the frame build
    (``_wide_exchange``), the one-step ``sw_wide`` call, the crop, and the
    whole body (``_wide_run`` of one step), on the state after the Euler
    step."""
    cfg = P.Config(nx=3600, ny=1800, periodic_x=False)
    _, comm = P.make_mesh_and_comm(cfg, device=dev)
    m = P._margin_rows(2)
    s = P._wide_run(P.initial_state(cfg, device=dev), 1, cfg, comm, 2, m,
                    euler_first=True)
    tok = P.create_token()
    frame, _ = P._wide_exchange(tuple(s), cfg, comm, m, tok)
    out = P._wide_kernel_call(frame, cfg, comm, False, 1, m)
    parts = {
        "frame_build": lambda: P._wide_exchange(tuple(s), cfg, comm, m, tok),
        "sw_wide_one_step": lambda: P._wide_kernel_call(frame, cfg, comm, False, 1, m),
        "crop": lambda: P._wide_crop(out, cfg, m),
        "body": lambda: P._wide_run(s, 1, cfg, comm, 2, m, euler_first=False),
    }
    ms = {k: time_graph_ms(fn, reps=20, warmup=3) for k, fn in parts.items()}
    print("walled megastep body, one step at 3600x1800, ms: " + json.dumps(ms))
    del s, frame, out
    torch.cuda.empty_cache()
    return ms


def device_busy(fn):
    """One call of ``fn`` (after one unprofiled call) under
    ``torch.profiler``: its wall, the device's busy share of it (the union
    of the device events' intervals over the wall) and the device time by
    kernel name, the largest four; ``None`` fields where the trace holds
    no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, cur, by_name = 0.0, None, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = e.name[:60]
            by_name[key] = by_name.get(key, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    for a, b in spans:
        if cur is None or a > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    busy += 0.0 if cur is None else cur[1] - cur[0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return {"wall_ms": wall * 1e3, "device_events": len(spans),
            "busy_share": busy / 1e3 / (wall * 1e3) if spans else None,
            "device_ms_by_kernel": dict(top) if spans else None}


def megastep_profiles(P, dev):
    """The megastep runs' 440 single steps under the profiler (``device_busy``),
    the pins built as ``solve_fused(unroll=N)`` builds them (the Euler step
    left out): periodic N = 1 and 440, walled N = 440."""
    from mpi4jax_tpu_torch.aot import pinning

    out = {}
    for label, cfg, n in (("periodic,unroll=1", P.Config(nx=3600, ny=1800), 1),
                          ("periodic,unroll=440", P.Config(nx=3600, ny=1800), 440),
                          ("walled,unroll=440",
                           P.Config(nx=3600, ny=1800, periodic_x=False), 440)):
        _, comm = P.make_mesh_and_comm(cfg, device=dev)
        step, chunk, size = P.select_steps("auto", cfg)
        if step is P.model_step_wide:
            m = P._margin_rows(size)

            def one(s, cfg=cfg, comm=comm, size=size, m=m):
                return P._wide_run(s, 1, cfg, comm, size, m, euler_first=False)
        else:
            def one(s, cfg=cfg, comm=comm, step=step, chunk=chunk, size=size):
                return P._run_steps(s, 1, cfg, comm, step, chunk, size)
        s0 = P.initial_state(cfg, device=dev)
        pp = pinning.compile(one, s0, comm=comm, unroll=n)

        def run(pp=pp, s0=s0, calls=440 // n):
            s = s0
            for _ in range(calls):
                s = pp(s)
            return s

        out[label] = device_busy(run)
        print(f"  profile, {label}: " + json.dumps(out[label]))
        del pp, s0
        torch.cuda.empty_cache()
    return out


def generic_step(v):
    """The test suite's step (tests/test_megastep.py:73-75): an allreduce
    SUM, then ``s*0.25 + v*0.5``."""
    from mpi4jax_tpu_torch import SUM, allreduce

    s, _ = allreduce(v, op=SUM)
    return s * 0.25 + v * 0.5


def host_us(fn, x, calls, chain=False):
    """Host microseconds a call over ``calls`` calls, synchronised at the
    end (``examples/aot_serving_step.py:90``'s ``per_call_us``); ``chain``
    feeds each output to the next call."""
    out = fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        out = fn(out if chain else x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def generic_megastep(dev):
    """The generic step on a one-rank CUDA comm: ``compile(unroll=8)``
    against 8 eager calls bit for bit; host microseconds a call, pinned
    (one-step graph, donated or not) against eager ``spmd``; MPX129 when
    ``MPI4JAX_TPU_FUSION`` is set between calls, ``repin()``; a capture
    made to fail must raise."""
    import mpi4jax_tpu_torch as tpx

    comm = tpx.Comm("x", mesh=tpx.make_world_mesh((1,), ("x",), device=dev))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(GENERIC_SHAPE).astype(np.float32)).to(dev)
    eager = tpx.spmd(generic_step, comm=comm)
    want = x
    for _ in range(GENERIC_UNROLL):
        want = eager(want)
    mega = tpx.compile(generic_step, x, comm=comm, unroll=GENERIC_UNROLL)
    got = mega(x)
    torch.cuda.synchronize()
    same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    print(f"generic step, compile(unroll={GENERIC_UNROLL}) on one CUDA rank "
          f"(graph: {mega.graph}): bit for bit with {GENERIC_UNROLL} eager calls: {same}")
    if not (mega.graph and same):
        raise AssertionError("the generic megastep is not a graph equal to eager calls")

    one = tpx.compile(generic_step, x, comm=comm)
    donated = tpx.compile(generic_step, x, comm=comm, donate_argnums=0)
    us = {"eager_spmd": host_us(eager, x, GENERIC_CALLS),
          "pinned": host_us(one, x, GENERIC_CALLS),
          "pinned_donated": host_us(donated, x.clone(), GENERIC_CALLS, chain=True),
          "pinned_unroll8_per_step": host_us(mega, x, GENERIC_CALLS) / GENERIC_UNROLL}
    copied = {"pinned": one.bytes_copied, "pinned_donated": donated.bytes_copied}
    print("  host us a call on (8, 256) f32: " + json.dumps(us)
          + "; bytes copied a call: " + json.dumps(copied))

    os.environ["MPI4JAX_TPU_FUSION"] = "auto"
    try:
        try:
            mega(x)
            raise AssertionError("a pin called after MPI4JAX_TPU_FUSION moved ran")
        except tpx.aot.StaleProgramError as e:
            stale = e.mpx_code
        again = mega.repin()
        regot = again(x)
        torch.cuda.synchronize()
        repinned = torch.equal(regot.view(torch.int32), want.view(torch.int32))
    finally:
        del os.environ["MPI4JAX_TPU_FUSION"]
    print(f"  MPI4JAX_TPU_FUSION=auto between calls: {stale}; repin() replays the "
          f"step bit for bit: {repinned}; the old pin valid again after the "
          f"variable is unset: {not mega.is_stale()}")
    if stale != "MPX129" or not repinned or mega.is_stale():
        raise AssertionError("staleness or repin did not hold on the card")
    del again, mega, one, donated

    def synchronising(v):
        return v * v.sum().item()

    try:
        tpx.compile(synchronising, x, comm=comm)
        raise AssertionError("a capture with a host synchronisation did not raise")
    except RuntimeError as e:
        failed = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    print(f"  a capture made to fail raised: {failed}")
    torch.cuda.synchronize()
    return {"bit_for_bit": same, "host_us_per_call": us,
            "bytes_copied_per_call": copied, "stale": stale, "repin_bit_for_bit": repinned,
            "failed_capture": failed}


def dispatch_phase(P, dev):
    """Phase 10 (see the module docstring); returns its summary, printed as
    one JSON line."""
    from mpi4jax_tpu_torch.aot import pinning

    t0 = time.perf_counter()
    t1 = 0.1 * P.DAY_IN_SECONDS
    pinning.reset_stats()
    out = {
        "periodic": megastep_solves(P, "sw_steps", "periodic",
                                    P.Config(nx=3600, ny=1800), "auto", dev, t1,
                                    UNROLLS, 1),
        "walled": megastep_solves(P, "sw_wide", "walled",
                                  P.Config(nx=3600, ny=1800, periodic_x=False),
                                  "auto", dev, t1, UNROLLS, 1),
        "split_phase": megastep_solves(P, "sw_phase", "split-phase",
                                       P.Config(nx=3600, ny=1800), "pallas_halo",
                                       dev, t1, (HALO_UNROLL,), 2),
        "walled_step_parts_ms": walled_step_parts(P, dev),
        "profiles": megastep_profiles(P, dev),
        "generic": generic_megastep(dev),
    }
    out["pin_stats"] = pinning.stats()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 10 (dispatch layer): {out['seconds']:.1f} s")
    return out


def dispatch_main():
    """``python3 chip_smoke.py --dispatch``: builds the stencil sources and
    runs phase 10 alone; one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    from mpi4jax_tpu_torch.kernels import _build
    from mpi4jax_tpu_torch.kernels import sw_phase as KP
    from mpi4jax_tpu_torch.kernels import sw_steps as K
    from mpi4jax_tpu_torch.kernels import sw_wide as KW
    from mpi4jax_tpu_torch.models import shallow_water as P

    t0 = time.perf_counter()
    _build.build_many([K.spec(), KP.spec(), KW.spec()])
    print(f"built the stencil sources in {time.perf_counter() - t0:.1f} s")
    out = dispatch_phase(P, torch.device("cuda"))
    print(smi)
    print(json.dumps({"dispatch": out}))
    return 0


def ring_rank(rank, device, b, t_loc, h, d, repeats):
    """One of four ranks of ``--ring``: the demo's causal and non-causal
    ring forward (no grad) at the attention width on ``device``,
    ``repeats`` calls each in this process; each call's wall and seconds
    inside exchanges, and the exchanges of a call."""
    from mpi4jax_tpu_torch import Comm, make_world_mesh
    from mpi4jax_tpu_torch.attention import ring_attention
    from mpi4jax_tpu_torch.models.long_context_attention import demo_shard
    from mpi4jax_tpu_torch.ops import _staging

    dev = torch.device(device)
    comm = Comm("sp", mesh=make_world_mesh((4,), ("sp",), device=dev))
    q, k, v = (torch.from_numpy(x).to(dev) for x in demo_shard(0, rank, b, t_loc, h, d))
    out = {}
    with torch.no_grad():
        for causal in (True, False):
            runs = []
            for _ in range(repeats):
                _staging.stats.reset()
                torch.cuda.synchronize(dev)
                start = time.perf_counter()
                ring_attention(q, k, v, comm=comm, causal=causal)
                torch.cuda.synchronize(dev)
                runs.append((time.perf_counter() - start, _staging.stats.seconds))
            out["causal" if causal else "full"] = {
                "wall": [w for w, _ in runs], "exchange_s": [e for _, e in runs],
                "exchanges": _staging.stats.calls}
    return out


def ring_main(repeats=8):
    """``python3 chip_smoke.py --ring``: builds the f32 forward source of the
    checkout that holds this script and times the four-rank ring forward
    of phase 6 (four gloo ranks on this card, 1024 tokens a rank, causal
    and not), ``repeats`` calls each in the same processes; prints rank
    0's walls and exchange seconds, one JSON line.  Run from two
    checkouts in one call, it sets their ring forwards side by side."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    from mpi4jax_tpu_torch.kernels import _build
    from mpi4jax_tpu_torch.kernels import flash_attention as FA
    from mpi4jax_tpu_torch.parallel import launch

    _build.build_many([FA.fwd_tf32_spec()])
    ranks = launch.run(ring_rank, 4, backend="gloo", device="cuda:0", timeout=600,
                       args=("cuda:0", ATTN_B, ATTN_T // 4, ATTN_H, ATTN_D, repeats))
    print(json.dumps({"ring_forward_rank0": ranks[0]}))
    return 0


def print_stencil_ptxas(_build):
    """Registers, spills and shared memory of the stencil kernels, from
    the ``-Xptxas -v`` logs."""
    for src in ("sw_steps", "sw_phase", "sw_wide"):
        for line in (_build.BUILD_DIR / f"{src}.build.log").read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {src}:", line.strip())


def shared_card_rank(rank, t1, device, nx, ny):
    """One of four ranks on a (2,2) grid of an ``nx`` x ``ny`` domain, all on
    ``device``: the solve to ``t1`` through "auto" (the wide-halo pair
    kernel), then 20 steps of the split-phase path against 20 of
    model_step_fast on the same ranks."""
    from mpi4jax_tpu_torch.kernels import sw_phase as KP
    from mpi4jax_tpu_torch.kernels import sw_wide as KW
    from mpi4jax_tpu_torch.models import shallow_water as P
    from mpi4jax_tpu_torch.ops import _staging

    dev = torch.device(device)
    cfg = P.Config(nx=nx, ny=ny, nproc_y=2, nproc_x=2)
    if P.select_steps("auto", cfg)[1] is not P.model_step2_wide:
        raise AssertionError("auto does not pick wide2 on the (2,2) grid")
    info = {}
    KW.counter.launches = 0
    _staging.stats.reset()
    wall, n_steps, final = P.solve_fused(cfg, t1, device=dev, fast="auto",
                                         return_state=True, info=info)
    # every run makes the same exchanges: the counts divide evenly by runs;
    # the seconds are the timed run's own, with its wall
    out = {
        "wall": wall, "n_steps": n_steps, "runs": info["runs"],
        "wide_launches": KW.counter.launches,
        "staged_bytes": _staging.stats.staged_bytes,
        "exchange_calls": _staging.stats.calls,
        "exchange_s": info["exchange_s"], "final": tuple(final),
    }
    del final

    _, comm = P.make_mesh_and_comm(cfg, device=dev)
    s = P.initial_state(cfg, rank=rank, device=dev)
    KP.counter.launches = 0
    first, multi = P.make_stepper(cfg, comm, fast="pallas_halo")
    halo = multi(first(s), 19)
    out["phase_launches"] = KP.counter.launches
    first, multi = P.make_stepper(cfg, comm, fast=True)
    fast = multi(first(s), 19)
    out["halo_err"] = max((a - b).abs().max().item() for a, b in zip(fast, halo))
    out["halo_band"] = min(band(a) for a in fast)
    out["halo_finite"] = all(bool(torch.isfinite(b).all()) for b in halo)
    return out


def print_flash_ptxas(log):
    """Registers and spills of the full-width (D = 128) flash kernels, from
    the ``-Xptxas -v`` log (the ``*_mma`` kernels take bf16 only, the
    ``*_tf32`` ones f32 only)."""
    name = None
    for line in log.read_text().splitlines():
        entry = re.search(r"(flash_(?:fwd(?:_causal)?|bwd_dq|bwd_dkv)(?:_mma|_tf32)?_kernel)"
                          r"ILi(\d+)E(f|13__nv_bfloat16)?((?:Lb[01]E)*)", line)
        if entry:
            kind, d, dtype, flags = entry.groups()
            extra = "".join(f", {n}" for n, f in zip(
                ("mask", "causal"), re.findall(r"Lb([01])E", flags)) if f == "1")
            f32 = dtype == "f" or "_tf32" in kind
            name = (f"{kind}<D={d}, {'f32' if f32 else 'bf16'}{extra}>"
                    if d == "128" else None)
        elif name and ("registers" in line or "spill" in line):
            print(f"  ptxas {name}:", line.replace("ptxas info    :", "").strip())


def flash_compare(label, want, got, o_rel):
    """Per field (o, m, l) of the partials: the largest difference where
    the plain version is finite, against its band; infinities must agree
    exactly and no NaN may appear.  Returns the differences by field."""
    errs, shown = {}, []
    for name, a, b in zip("oml", want, got):
        a, b = a.float(), b.float()
        if bool(torch.isnan(b).any()):
            raise AssertionError(f"{label}: {name} holds NaN")
        fin = torch.isfinite(a)
        if not (torch.equal(fin, torch.isfinite(b))
                and torch.equal(a[~fin], b[~fin])):
            raise AssertionError(f"{label}: {name} differs where plain is infinite")
        rel = o_rel if name == "o" else FLASH_REL[name]
        top = a[fin].abs().max().item() if bool(fin.any()) else 0.0
        lim = (0.0 if rel == FLASH_BF16_O_REL else rel) + rel * top
        err = (a[fin] - b[fin]).abs().max().item() if bool(fin.any()) else 0.0
        if err > lim:
            raise AssertionError(f"{label}: {name} off by {err:.3e} > {lim:.3e}")
        errs[name] = err
        shown.append(f"{name} {err:.3e} (band {lim:.3e})")
    print(f"  {label} max|diff|: " + ", ".join(shown))
    return errs


def flash_need(q, k, pairs, masked):
    """Bytes and operations one partials call needs: q, k, v read once, o,
    m, l written once (and the mask read); two products of D per score
    pair the call has to compute, at the inputs' peak rate: bf16 on the
    tensor cores; f32 also on them by 3xTF32, three TF32 operations for
    each f32 one, so a third of the TF32 rate (``f32_bound`` gives the
    CUDA cores' bound)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    moved = q.element_size() * (2 * b * tq * h * d + 2 * b * tk * h * d)
    moved += 8 * b * h * tq + (tq * tk if masked else 0)
    peak = PEAK_BF16_PER_S if q.dtype == torch.bfloat16 else PEAK_TF32_PER_S / 3
    return moved, 4 * d * pairs * b * h, peak


def sdpa(q, k, v, mask, causal):
    """The library yardstick: one ``scaled_dot_product_attention`` call on
    the (B, H, T, D) views, its time and the backend PyTorch picks."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    choice = torch._fused_sdp_choice(qt, kt, vt, attn_mask=mask, dropout_p=0.0,
                                     is_causal=causal)
    ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal), reps=10, warmup=3)
    return ms, SDPBackend(choice).name


FWD_NAMES = ("flash_fwd_tf32", "flash_fwd_causal_tf32", "flash_fwd_mma",
             "flash_fwd_causal_mma")


def fwd_counters(FA):
    """The forward kernels' launch counters, by ``FWD_NAMES``."""
    return dict(zip(FWD_NAMES, (FA.counter_tf32, FA.counter_causal_tf32, FA.counter_mma,
                                FA.counter_causal_mma)))


def check_flash_kernels(FA, dev):
    """The flash forward kernels against their plain version at full
    width: f32 (the 3xTF32 ``flash_fwd_tf32``, ``flash_fwd_causal_tf32``)
    and bf16 (the tensor-core ``flash_fwd_mma``, ``flash_fwd_causal_mma``)
    each unmasked, masked (p = 0.8), causal, a ragged masked block (4000 x
    4100) through a strided query view, a fully masked block, which must
    give (0, -inf, 0) on every row, and a query view whose strides are
    multiples of 4 (in bf16 not of 8), which must give the partials of its
    contiguous copy bit for bit.  Each call must launch its dtype's
    kernel.  Returns the worst difference of each kernel and its cases."""
    b, t, h, d = ATTN_B, ATTN_T, ATTN_H, ATTN_D
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((b, t, h, d), device=dev, generator=gen)
               for _ in range(3))
    scale = 1.0 / d**0.5
    mask = torch.rand((t, t), device=dev, generator=gen) < 0.8
    tq_r, tk_r = t - 96, t + 4  # a ragged block: 4000 x 4100 at T = 4096
    k_r, v_r = (torch.randn((b, tk_r, h, d), device=dev, generator=gen)
                for _ in range(2))
    mask_r = torch.rand((tq_r, tk_r), device=dev, generator=gen) < 0.8
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    # the queries of a (B, T, H, D + 4) tensor: strides multiples of 4, not 8
    wide = torch.randn((b, t, h, d + 4), device=dev, generator=gen)
    q4f, q4 = wide[..., 4:], wide.bfloat16()[..., 4:]
    none = torch.zeros((t, t), dtype=torch.bool, device=dev)
    cases = [
        ("f32", q, k, v, None, False),
        ("f32,mask", q, k, v, mask, False),
        ("f32,causal", q, k, v, None, True),
        ("bf16", qb, kb, vb, None, False),
        ("bf16,causal", qb, kb, vb, None, True),
        # the queries a strided view: the kernel reads by strides
        (f"f32,ragged {tq_r}x{tk_r},mask", q[:, :tq_r], k_r, v_r, mask_r, False),
        ("bf16,mask", qb, kb, vb, mask, False),
        (f"bf16,ragged {tq_r}x{tk_r},mask", qb[:, :tq_r], k_r.bfloat16(),
         v_r.bfloat16(), mask_r, False),
        ("bf16,fully masked", qb, kb, vb, none, False),
        ("bf16,q stride 4", q4, kb, vb, None, False),
        ("f32,fully masked", q, k, v, none, False),
        ("f32,q stride 4", q4f, k, v, None, False),
    ]
    counters = fwd_counters(FA)
    worst = dict.fromkeys(FWD_NAMES, 0.0)
    by_case = {name: {} for name in FWD_NAMES}
    for label, qq, kk, vv, mm, causal in cases:
        bf16 = qq.dtype == torch.bfloat16
        name = ("flash_fwd_causal" if causal else "flash_fwd") + ("_mma" if bf16 else "_tf32")
        want = FA.block_partials_plain(qq, kk, vv, mm, scale=scale, causal=causal)
        before = {n: c.launches for n, c in counters.items()}
        got = FA.flash_block_partials(qq, kk, vv, mm, scale=scale, causal=causal)
        torch.cuda.synchronize()
        moved = [n for n, c in counters.items() if c.launches != before[n]]
        if moved != [name]:
            raise AssertionError(f"forward({label}) launched {moved}, expected {name}")
        o_rel = (FLASH_BF16_O_REL if bf16
                 else FLASH_CAUSAL_O_REL if causal else FLASH_REL["o"])
        errs = flash_compare(f"{name}({label})", want, got, o_rel)
        if mm is none:
            o, m, l = got
            if not (bool(torch.isneginf(m).all()) and bool((l == 0).all())
                    and bool((o == 0).all())):
                raise AssertionError(f"{name}: a fully masked block is not (0, -inf, 0)")
            print(f"  {name}({label}): m = -inf, l = 0, o = 0 on every row")
        if qq is q4 or qq is q4f:
            strides = qq.stride()[:3]
            if any(s % 4 for s in strides) or all(s % 8 == 0 for s in strides):
                raise AssertionError(f"{label}: strides {strides} are not multiples of "
                                     "4 but not of 8")
            copy = FA.flash_block_partials(qq.contiguous(), kk, vv, mm, scale=scale)
            if not all(torch.equal(x, y) for x, y in zip(copy, got)):
                raise AssertionError(f"{name}: a stride-4 query view does not give "
                                     "the partials of its contiguous copy")
            print(f"  {name}({label}, q strides {qq.stride()}): the partials of its "
                  "contiguous copy, bit for bit")
        del want, got
        tq, tk = qq.shape[1], kk.shape[1]
        pairs = (tq * (tq + 1) // 2 if causal else tq * tk if mm is None
                 else int(mm.sum().item()))
        need = flash_need(qq, kk, pairs, mm is not None)
        case = timed_case(
            f"{name}({label})",
            lambda: FA.flash_block_partials(qq, kk, vv, mm, scale=scale, causal=causal),
            lambda: FA.block_partials_plain(qq, kk, vv, mm, scale=scale, causal=causal),
            *need, reps=10)
        if not bf16:
            f32_bound(case, *need[:2])
        case["library_ms"], case["library"] = sdpa(qq, kk, vv, mm, causal)
        print(f"    scaled_dot_product_attention: {case['library_ms']:.4f} ms "
              f"({case['library']})")
        case["max_abs_err"] = errs
        by_case[name][label] = case
        worst[name] = max(worst[name], *errs.values())
    return worst, by_case


def single_gpu_attention(TA, FA, q, k, v):
    """``flash_attention`` at full width, causal and not: against
    ``reference_attention`` on the card, its time, tokens/s and launches.
    Returns the outputs, kept for the four-rank comparison."""
    b, t = q.shape[:2]
    outs, worst = {}, 0.0
    for causal in (False, True):
        for c in FA.counter_tf32, FA.counter_causal_tf32:
            c.launches = 0
        out = TA.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        launches = (FA.counter_tf32.launches, FA.counter_causal_tf32.launches)
        if launches != ((0, 1) if causal else (1, 0)):
            raise AssertionError(f"flash_attention(causal={causal}) launched "
                                 f"{launches} (flash_fwd_tf32, flash_fwd_causal_tf32)")
        ref = TA.reference_attention(q, k, v, causal=causal)
        err = (out - ref).abs().max().item()
        if not (bool(torch.isfinite(out).all())
                and torch.allclose(out, ref, rtol=ATTN_RTOL, atol=ATTN_ATOL)):
            raise AssertionError(f"flash_attention(causal={causal}) off "
                                 f"reference_attention by {err:.3e}")
        del ref
        ms = time_ms(lambda: TA.flash_attention(q, k, v, causal=causal),
                     reps=10, warmup=3)
        print(f"flash_attention(causal={causal}) at B={b}, T={t}, H={q.shape[2]}, "
              f"D={q.shape[3]}: {ms:.4f} ms per call, {b * t / ms * 1e3:.0f} "
              f"tokens/s; max|diff| from reference_attention {err:.3e} "
              f"(rtol {ATTN_RTOL}, atol {ATTN_ATOL})")
        outs[causal] = out
        worst = max(worst, err)
    return outs, worst


def four_rank_attention(LCA, launch, single, device):
    """The demo's entry point on four gloo ranks on this card (T_global =
    4096, 1024 tokens a rank): causal and non-causal ring, causal Ulysses,
    each rank's output against its slice of single-GPU
    ``flash_attention``, and each rank's kernel launches."""
    t_loc = ATTN_T // 4
    kwargs = {"b": ATTN_B, "t_loc": t_loc, "h": ATTN_H, "d": ATTN_D,
              "runs": (("ring", True), ("ring", False), ("ulysses", True)),
              "repeats": 2}
    t0 = time.perf_counter()
    ranks = launch.run(LCA.rank_main, 4, backend="gloo", device=device,
                       timeout=600, args=(device, kwargs))
    print(f"four ranks, long-context attention: {time.perf_counter() - t0:.1f} s "
          "with start-up")
    # launches per rank r: (flash_fwd_tf32, flash_fwd_causal_tf32)
    expect = {"ring/causal": lambda r: (r, 1), "ring/full": lambda r: (4, 0),
              "ulysses/causal": lambda r: (0, 1)}
    worst, launches = 0.0, {"flash_fwd_tf32": 0, "flash_fwd_causal_tf32": 0}
    for key, want in expect.items():
        ref = single[key.endswith("causal")]
        for r, res in enumerate(ranks):
            got = res[key]["launches"]
            if (got["flash_fwd_tf32"], got["flash_fwd_causal_tf32"]) != want(r):
                raise AssertionError(f"{key} rank {r}: launches {got}, "
                                     f"expected {want(r)}")
            for name in launches:
                launches[name] += got[name]
            out = torch.from_numpy(res[key]["out"])
            mine = ref[:, r * t_loc:(r + 1) * t_loc].cpu()
            err = (out - mine).abs().max().item()
            if not (bool(torch.isfinite(out).all())
                    and torch.allclose(out, mine, rtol=ATTN_RTOL, atol=ATTN_ATOL)):
                raise AssertionError(f"{key} rank {r}: off single-GPU "
                                     f"flash_attention by {err:.3e}")
            worst = max(worst, err)
            print(f"  {key} rank {r}: max|diff| {err:.3e} from single-GPU "
                  f"flash_attention; launches {got}; wall {res[key]['wall']:.4f} s, "
                  f"{res[key]['exchange_s']:.4f} s in {res[key]['exchange_calls']} "
                  f"exchanges, {res[key]['staged_bytes'] / 1e6:.1f} MB staged")
    r0 = ranks[0]
    print("four processes share one card (gloo, exchanges staged through host "
          "memory; not a scaling result): rank 0 wall " + ", ".join(
              f"{key} {r0[key]['wall']:.4f} s" for key in expect))
    return worst, launches, {key: {"wall_rank0": r0[key]["wall"],
                                   "exchange_s_rank0": r0[key]["exchange_s"],
                                   "staged_bytes_rank0": r0[key]["staged_bytes"]}
                             for key in expect}


def bwd_need(q, k, pairs, masked, outputs):
    """Bytes and operations one backward kernel call needs: q, k, v and
    g_o read once, m and g_l read, its outputs (``"dq"``, or ``"dkv"``: dk
    and dv) written once (and the mask read); 3 products of D per score
    pair for dq (s, dp, ds k), 4 for dk/dv (s, dp, ds q, p g_o), at the
    inputs' peak rate: bf16 on the tensor cores; f32 also on them by
    3xTF32, three TF32 operations for each f32 one, so a third of the
    TF32 rate (``f32_bound`` gives the CUDA cores' bound)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    es = q.element_size()
    moved = es * (2 * b * tq * h * d + 2 * b * tk * h * d) + 8 * b * h * tq
    moved += tq * tk if masked else 0
    moved += es * (b * tq * h * d if outputs == "dq" else 2 * b * tk * h * d)
    products = 3 if outputs == "dq" else 4
    peak = PEAK_BF16_PER_S if q.dtype == torch.bfloat16 else PEAK_TF32_PER_S / 3
    return moved, 2 * products * d * pairs * b * h, peak


def f32_bound(case, moved, ops):
    """Add to an f32 ``case`` (forward or backward) the bound of the same
    call on the CUDA cores' f32 rate (the bound of a design without the
    tensor cores, kept so that rows compare across designs); print it."""
    case["f32_cuda_core_bound_ms"] = bound_ms(moved, ops, PEAK_F32_PER_S)[0]
    print(f"    f32 CUDA-core bound {case['f32_cuda_core_bound_ms']:.4f} ms; "
          f"kernel at {case['bound_ms'] / case['ms']:.1%} of the 3xTF32 bound")


def sdpa_bwd(q, k, v, mask, causal, g_o):
    """The library yardstick of the backward: the autograd backward of one
    ``scaled_dot_product_attention`` call on the (B, H, T, D) views, its
    time (dq, dk and dv together) and the backend PyTorch picks."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    choice = torch._fused_sdp_choice(qt, kt, vt, attn_mask=mask, dropout_p=0.0,
                                     is_causal=causal)
    try:
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                             is_causal=causal)
        g = g_o.transpose(1, 2)
        ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), g,
                                                 retain_graph=True),
                     reps=10, warmup=3)
    except RuntimeError as e:  # a yardstick only: no time rather than no run
        return None, f"{SDPBackend(choice).name} failed: {str(e).splitlines()[0]}"
    return ms, SDPBackend(choice).name


def bwd_compare(label, want, got, dtype):
    """Per gradient: max|diff| against 1e-3 max|ref| + 1e-4 (f32) or
    4 * 2^-8 max|ref| (bf16); NaN fails.  Returns the differences."""
    errs, shown = {}, []
    for name, a, b in zip(("dq", "dk", "dv"), want, got):
        if b.dtype != dtype or bool(torch.isnan(b).any()):
            raise AssertionError(f"{label}: {name} is {b.dtype} or holds NaN")
        a, b = a.float(), b.float()
        top = a.abs().max().item()
        lim = FLASH_BF16_O_REL * top if dtype == torch.bfloat16 else BWD_REL * top + BWD_ABS
        err = (a - b).abs().max().item()
        if err > lim:
            raise AssertionError(f"{label}: {name} off by {err:.3e} > {lim:.3e}")
        errs[name] = err
        shown.append(f"{name} {err:.3e} (band {lim:.3e})")
    print(f"  {label} max|diff|: " + ", ".join(shown))
    return errs


BWD_NAMES = ("flash_bwd_dq_tf32", "flash_bwd_dkv_tf32", "flash_bwd_dq_mma",
             "flash_bwd_dkv_mma")


def bwd_counters(FA):
    """The backward kernels' launch counters, by ``BWD_NAMES``."""
    return dict(zip(BWD_NAMES, (FA.counter_bwd_dq_tf32, FA.counter_bwd_dkv_tf32,
                                FA.counter_bwd_dq_mma, FA.counter_bwd_dkv_mma)))


def sass_tf32_mma(lib, nvcc):
    """The number of TF32 tensor-core instructions (``HMMA...TF32``) in the
    machine code of library ``lib``, by ``cuobjdump -sass`` (beside
    ``nvcc``); raises if there is none."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    n = len(re.findall(r"HMMA\.\w+\.F32\.TF32", sass))
    print(f"  {lib.name}: {n} HMMA TF32 instructions in its SASS")
    if n == 0:
        raise AssertionError(f"{lib.name} holds no TF32 mma instruction")
    return n


def check_flash_bwd_kernels(FA, dev):
    """The backward kernels against the plain backward at full width: f32
    (the 3xTF32 ``flash_bwd_dq_tf32``, ``flash_bwd_dkv_tf32``) and bf16
    (the tensor-core ``flash_bwd_dq_mma``, ``flash_bwd_dkv_mma``) each
    unmasked, masked (p = 0.8), causal, a ragged masked block (4000 x
    4100) through a strided query view, and a fully masked block, which
    must give exactly zero (timed in f32).  ``m`` comes from the forward
    kernel, the cotangents g_o and g_l from a seeded generator.  Each call must launch its dtype's kernel.
    Returns the worst difference of each kernel and its cases."""
    b, t, h, d = ATTN_B, ATTN_T, ATTN_H, ATTN_D
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn((b, t, h, d), device=dev, generator=gen)
               for _ in range(3))
    scale = 1.0 / d**0.5
    mask = torch.rand((t, t), device=dev, generator=gen) < 0.8
    none = torch.zeros((t, t), dtype=torch.bool, device=dev)
    tq_r, tk_r = t - 96, t + 4
    ragged = (q[:, :tq_r], torch.randn((b, tk_r, h, d), device=dev, generator=gen),
              torch.randn((b, tk_r, h, d), device=dev, generator=gen),
              torch.rand((tq_r, tk_r), device=dev, generator=gen) < 0.8)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    cases = [
        ("f32", q, k, v, None, False),
        ("f32,mask", q, k, v, mask, False),
        ("f32,causal", q, k, v, None, True),
        ("bf16", qb, kb, vb, None, False),
        ("bf16,causal", qb, kb, vb, None, True),
        (f"f32,ragged {tq_r}x{tk_r},mask", *ragged, False),
        ("bf16,mask", qb, kb, vb, mask, False),
        (f"bf16,ragged {tq_r}x{tk_r},mask", qb[:, :tq_r], ragged[1].bfloat16(),
         ragged[2].bfloat16(), ragged[3], False),
        ("f32,fully masked", q, k, v, none, False),
    ]
    counters = bwd_counters(FA)
    worst = dict.fromkeys(BWD_NAMES, 0.0)
    by_case = {name: {} for name in BWD_NAMES}
    for label, qq, kk, vv, mm, causal in cases:
        with torch.no_grad():
            _, m, _ = FA.flash_block_partials(qq, kk, vv, mm, scale=scale, causal=causal)
        g_o = torch.randn(qq.shape, device=dev, generator=gen).to(qq.dtype)
        g_l = torch.randn(m.shape, device=dev, generator=gen)
        args, kw = (qq, kk, vv, mm, m, g_o, g_l), {"scale": scale, "causal": causal}
        sfx = "_mma" if qq.dtype == torch.bfloat16 else "_tf32"
        dq_name, dkv_name = f"flash_bwd_dq{sfx}", f"flash_bwd_dkv{sfx}"
        want = FA.block_partials_bwd_plain(*args, **kw)
        before = {n: c.launches for n, c in counters.items()}
        got = (FA.flash_bwd_dq(*args, **kw), *FA.flash_bwd_dkv(*args, **kw))
        torch.cuda.synchronize()
        moved = [n for n, c in counters.items() if c.launches != before[n]]
        if moved != [dq_name, dkv_name]:
            raise AssertionError(f"backward({label}) launched {moved}, expected "
                                 f"{dq_name} and {dkv_name}")
        errs = bwd_compare(f"backward({label})", want, got, qq.dtype)
        if mm is none and not all(bool((x == 0).all()) for x in got):
            raise AssertionError(f"backward({label}) is not zero")
        del want, got
        tq, tk = qq.shape[1], kk.shape[1]
        pairs = (tq * (tq + 1) // 2 if causal else tq * tk if mm is None
                 else int(mm.sum().item()))
        lib_ms, lib = sdpa_bwd(qq, kk, vv, mm, causal, g_o)
        for name, fn, outputs, errs_of in (
                (dq_name, FA.flash_bwd_dq, "dq", ("dq",)),
                (dkv_name, FA.flash_bwd_dkv, "dkv", ("dk", "dv"))):
            need = bwd_need(qq, kk, pairs, mm is not None, outputs)
            case = timed_case(
                f"{name}({label})", lambda fn=fn: fn(*args, **kw),
                lambda: FA.block_partials_bwd_plain(*args, **kw), *need, reps=10)
            if qq.dtype == torch.float32:
                f32_bound(case, *need[:2])
            case["library_ms"], case["library"] = lib_ms, lib
            case["max_abs_err"] = {e: errs[e] for e in errs_of}
            by_case[name][label] = case
            worst[name] = max(worst[name], *case["max_abs_err"].values())
        dq_kv = by_case[dq_name][label]["ms"] + by_case[dkv_name][label]["ms"]
        lib_txt = "not timed" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"    scaled_dot_product_attention backward (dq, dk, dv in one "
              f"call): {lib_txt} ({lib}); dq + dk/dv kernels {dq_kv:.4f} ms "
              "(plain times are the whole plain backward)")

    # no attendable key in bf16 (f32 is a case above): zero gradients, never NaN
    with torch.no_grad():
        _, m, _ = FA.flash_block_partials(qb, kb, vb, none, scale=scale)
    g_o = torch.randn(q.shape, device=dev, generator=gen).to(qb.dtype)
    g_l = torch.randn(m.shape, device=dev, generator=gen)
    dq = FA.flash_bwd_dq(qb, kb, vb, none, m, g_o, g_l, scale=scale)
    dk, dv = FA.flash_bwd_dkv(qb, kb, vb, none, m, g_o, g_l, scale=scale)
    torch.cuda.synchronize()
    if not all(bool((x == 0).all()) for x in (dq, dk, dv)):
        raise AssertionError("flash_bwd_dq_mma, flash_bwd_dkv_mma: backward of a "
                             "fully masked bf16 block is not zero")
    print("  flash_bwd_dq_mma, flash_bwd_dkv_mma(bf16, fully masked): dq = dk = dv = 0")
    return worst, by_case


def sass_census(lib, nvcc):
    """Per function of library ``lib`` (its ``cuobjdump -sass``): the
    instructions in all, those in its loops' division paths (FCHK, the f32
    division's check; DFMA, the double division of TailDivisor's tail),
    f32 arithmetic, shared-memory and copy instructions, barriers and
    branches, counted in the code as compiled (each counted once, not per
    execution)."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    kinds = {"f32": ("FADD", "FMUL", "FFMA", "FSEL", "FSETP", "FMNMX", "MUFU"),
             "fchk": ("FCHK",), "dfma": ("DFMA", "DMUL"), "lds_sts": ("LDS", "STS"),
             "cp_async": ("LDGSTS",), "global": ("LDG", "STG"),
             "barrier": ("BAR",), "branch": ("BRA", "BSSY", "BSYNC")}
    out, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            out[name] = dict.fromkeys(["all", *kinds], 0)
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", ln)
        if name is None or m is None or m.group(1) == "NOP":
            continue
        out[name]["all"] += 1
        for kind, ops in kinds.items():
            if m.group(1) in ops:
                out[name][kind] += 1
    return out


def sass_digest(lib, nvcc):
    """sha256 of the machine code of library ``lib``: the instructions of
    each function of its ``cuobjdump -sass``, functions in sorted order,
    with nothing that names the file (its name, its path, and the hash of
    it in the names of anonymous namespaces)."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    blocks = []
    for ln in sass.splitlines():
        if "Function :" in ln:
            blocks.append([])
        elif blocks and re.search(r"/\*[0-9a-f]{4}\*/", ln):
            blocks[-1].append(re.sub(r"\d*_GLOBAL__N__\w+", "_GLOBAL__N__", ln.strip()))
    code = sorted(hashlib.sha256("\n".join(b).encode()).hexdigest() for b in blocks)
    return hashlib.sha256("\n".join(code).encode()).hexdigest()


def backward_digests(FA, dev):
    """sha256 of dq, dk and dv from the backward kernels at B=4, T=4096,
    H=8, each head dim the kernels are built for, f32 and bf16, unmasked,
    masked (p = 0.8) and causal (every template instance of both backward
    sources), on inputs from a seeded generator with ``m`` from the plain
    forward: what the backward kernels alone give, whatever forward kernel
    the checkout routes to.  Equal digests from two checkouts on one card
    say their backward kernels give the same bits."""
    b, t, h = ATTN_B, ATTN_T, ATTN_H
    gen = torch.Generator(device=dev).manual_seed(2)
    mask = torch.rand((t, t), device=dev, generator=gen) < 0.8
    out = {}
    for d in FA.HEAD_DIMS:
        q, k, v, g_o = (torch.randn((b, t, h, d), device=dev, generator=gen)
                        for _ in range(4))
        g_l = torch.randn((b, h, t), device=dev, generator=gen)
        scale = 1.0 / d**0.5
        for dtype in (torch.float32, torch.bfloat16):
            qq, kk, vv, gg = (x.to(dtype) for x in (q, k, v, g_o))
            for label, mm, causal in (("", None, False), (",mask", mask, False),
                                      (",causal", None, True)):
                _, m, _ = FA.block_partials_plain(qq, kk, vv, mm, scale=scale,
                                                  causal=causal)
                args = (qq, kk, vv, mm, m, gg, g_l)
                kw = {"scale": scale, "causal": causal}
                grads = (FA.flash_bwd_dq(*args, **kw), *FA.flash_bwd_dkv(*args, **kw))
                digest = hashlib.sha256()
                for x in grads:
                    digest.update(x.contiguous().view(torch.uint8).cpu().numpy().tobytes())
                kind = "f32" if dtype == torch.float32 else "bf16"
                out[f"{kind},D={d}{label}"] = digest.hexdigest()
                del m, grads
    return out


def bwd_digest_main():
    """``python3 chip_smoke.py --bwd-digest``: builds the two backward
    sources of the checkout that holds this script and prints the digests
    of their machine code and of their gradients (``backward_digests``),
    one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mpi4jax_tpu_torch.kernels import _build
    from mpi4jax_tpu_torch.kernels import flash_attention as FA

    libs = _build.build_many([FA.tf32_spec(), FA.mma_spec()])
    sass = {lib.name: sass_digest(lib, _build._nvcc()) for lib in libs}
    print(json.dumps({"sass": sass, "grads": backward_digests(FA, torch.device("cuda"))}))
    return 0


def single_gpu_attention_grads(TA, FA, q, k, v):
    """Autograd through ``flash_attention`` at full width, causal and not,
    against ``reference_attention``'s gradients on the card; the launches
    of one forward and backward, its time and tokens/s."""
    b, t = q.shape[:2]
    gen = torch.Generator(device=q.device).manual_seed(2)
    g = torch.randn(q.shape, device=q.device, generator=gen)
    counters = (FA.counter_tf32, FA.counter_causal_tf32, *bwd_counters(FA).values())
    worst, runs = 0.0, {}
    for causal in (False, True):
        for c in counters:
            c.launches = 0
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        TA.flash_attention(*leaves, causal=causal).backward(g)
        torch.cuda.synchronize()
        launches = tuple(c.launches for c in counters)
        if launches != ((0, 1, 1, 1, 0, 0) if causal else (1, 0, 1, 1, 0, 0)):
            raise AssertionError(f"flash_attention(causal={causal}) forward and "
                                 f"backward launched {launches} (flash_fwd_tf32, "
                                 "flash_fwd_causal_tf32, flash_bwd_dq_tf32, "
                                 "flash_bwd_dkv_tf32, flash_bwd_dq_mma, "
                                 "flash_bwd_dkv_mma)")
        refs = [x.detach().requires_grad_(True) for x in (q, k, v)]
        TA.reference_attention(*refs, causal=causal).backward(g)
        err = 0.0
        for name, a, r in zip(("dq", "dk", "dv"), leaves, refs):
            err = max(err, (a.grad - r.grad).abs().max().item())
            if not (bool(torch.isfinite(a.grad).all())
                    and torch.allclose(a.grad, r.grad, rtol=GRAD_RTOL, atol=GRAD_ATOL)):
                raise AssertionError(f"flash_attention(causal={causal}) {name} off "
                                     f"reference_attention's by {err:.3e}")
        del refs

        def fwd_bwd():
            out = TA.flash_attention(*leaves, causal=causal)
            torch.autograd.grad(out, leaves, g)

        ms = time_ms(fwd_bwd, reps=10, warmup=3)
        print(f"flash_attention(causal={causal}) forward + backward at B={b}, T={t}: "
              f"{ms:.4f} ms, {b * t / ms * 1e3:.0f} tokens/s; gradients max|diff| "
              f"from reference_attention's {err:.3e} (rtol {GRAD_RTOL}, atol "
              f"{GRAD_ATOL}); launches {launches}")
        runs["causal" if causal else "full"] = {"ms": ms, "tokens_per_s": b * t / ms * 1e3}
        worst = max(worst, err)
    return worst, runs


def bf16_attention_forward(TA, FA, q, k, v):
    """The bf16 path forward alone: ``flash_attention`` on the bf16 values
    of ``q, k, v`` at full width, causal and not.  Each call launches
    ``flash_fwd_mma`` or ``flash_fwd_causal_mma`` once and neither f32
    forward kernel; its bf16 output holds 4 * 2^-8 of max|ref| against
    ``reference_attention`` on the same values in f32.  Returns the worst
    difference, the launches of both calls and each call's time and
    tokens/s."""
    b, t = q.shape[:2]
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    counters = fwd_counters(FA)
    worst, runs, total = 0.0, {}, dict.fromkeys(counters, 0)
    for causal in (False, True):
        for c in counters.values():
            c.launches = 0
        out = TA.flash_attention(qb, kb, vb, causal=causal)
        torch.cuda.synchronize()
        launches = {n: c.launches for n, c in counters.items()}
        want = (0, 0) + ((0, 1) if causal else (1, 0))
        if tuple(launches.values()) != want:
            raise AssertionError(f"bf16 flash_attention(causal={causal}) launched "
                                 f"{launches}, expected {want}")
        for n in total:
            total[n] += launches[n]
        ref = TA.reference_attention(*(x.float() for x in (qb, kb, vb)), causal=causal)
        lim = FLASH_BF16_O_REL * ref.abs().max().item()
        err = (out.float() - ref).abs().max().item()
        if out.dtype != torch.bfloat16 or not bool(torch.isfinite(out).all()) \
                or err > lim:
            raise AssertionError(f"bf16 flash_attention(causal={causal}) is {out.dtype}, "
                                 f"not finite or off reference_attention by {err:.3e} "
                                 f"> {lim:.3e}")
        del ref, out
        ms = time_ms(lambda: TA.flash_attention(qb, kb, vb, causal=causal),
                     reps=20, warmup=5)
        print(f"flash_attention(causal={causal}) bf16 forward at B={b}, T={t}: "
              f"{ms:.4f} ms, {b * t / ms * 1e3:.0f} tokens/s; max|diff| from "
              f"reference_attention in f32 {err:.3e} (band {lim:.3e}); launches "
              f"{launches}")
        runs["causal" if causal else "full"] = {"ms": ms, "tokens_per_s": b * t / ms * 1e3,
                                                "max_abs_err": err}
        worst = max(worst, err)
    return worst, total, runs


def bf16_attention_grads(TA, FA, q, k, v):
    """The bf16 path: autograd through ``flash_attention`` on the bf16
    values of ``q, k, v`` at full width, causal and not.  Each forward and
    backward launches its tensor-core forward kernel (``flash_fwd_mma`` or
    ``flash_fwd_causal_mma``) once and ``flash_bwd_dq_mma`` and
    ``flash_bwd_dkv_mma`` once each, and no f32 kernel; the
    bf16 gradients hold 4 * 2^-8 of max|ref| against those of
    ``reference_attention`` on the same values in f32.  Returns the worst
    difference, the launches of both runs and each run's time and
    tokens/s."""
    b, t = q.shape[:2]
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    gen = torch.Generator(device=q.device).manual_seed(3)
    g = torch.randn(q.shape, device=q.device, generator=gen).bfloat16()
    counters = {**fwd_counters(FA), **bwd_counters(FA)}
    worst, runs, total = 0.0, {}, dict.fromkeys(counters, 0)
    for causal in (False, True):
        for c in counters.values():
            c.launches = 0
        leaves = [x.detach().requires_grad_(True) for x in (qb, kb, vb)]
        TA.flash_attention(*leaves, causal=causal).backward(g)
        torch.cuda.synchronize()
        launches = {n: c.launches for n, c in counters.items()}
        want = (0, 0) + ((0, 1) if causal else (1, 0)) + (0, 0, 1, 1)
        if tuple(launches.values()) != want:
            raise AssertionError(f"bf16 flash_attention(causal={causal}) launched "
                                 f"{launches}, expected {want}")
        for n in total:
            total[n] += launches[n]
        refs = [x.detach().float().requires_grad_(True) for x in (qb, kb, vb)]
        TA.reference_attention(*refs, causal=causal).backward(g.float())
        shown = []
        for name, a, r in zip(("dq", "dk", "dv"), leaves, refs):
            if a.grad.dtype != torch.bfloat16 or not bool(torch.isfinite(a.grad).all()):
                raise AssertionError(f"bf16 flash_attention(causal={causal}) {name} "
                                     f"is {a.grad.dtype} or not finite")
            lim = FLASH_BF16_O_REL * r.grad.abs().max().item()
            err = (a.grad.float() - r.grad).abs().max().item()
            if err > lim:
                raise AssertionError(f"bf16 flash_attention(causal={causal}) {name} "
                                     f"off reference_attention's by {err:.3e} > {lim:.3e}")
            shown.append(f"{name} {err:.3e} (band {lim:.3e})")
            worst = max(worst, err)
        del refs

        def fwd_bwd():
            out = TA.flash_attention(*leaves, causal=causal)
            torch.autograd.grad(out, leaves, g)

        ms = time_ms(fwd_bwd, reps=10, warmup=3)
        print(f"flash_attention(causal={causal}) bf16 forward + backward at B={b}, "
              f"T={t}: {ms:.4f} ms, {b * t / ms * 1e3:.0f} tokens/s; gradients "
              f"max|diff| from reference_attention's in f32: " + ", ".join(shown)
              + f"; launches {launches}")
        runs["causal" if causal else "full"] = {"ms": ms, "tokens_per_s": b * t / ms * 1e3}
    return worst, total, runs


def single_gpu_training(LCT, TA, dev):
    """Five SGD steps of the training example at full width as a world of
    one: the loss falls, every step launches the flash kernels it should,
    and the first step's loss and gradients equal those of the same step
    with ``reference_attention`` under autograd."""
    res = LCT.main(dev, **TRAIN)
    losses = res["losses"]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"training did not reduce the loss: {losses}")
    want = {"flash_fwd_tf32": 0, "flash_fwd_causal_tf32": 2, "flash_bwd_dq_tf32": 1,
            "flash_bwd_dkv_tf32": 1, "flash_fwd_mma": 0, "flash_fwd_causal_mma": 0,
            "flash_bwd_dq_mma": 0, "flash_bwd_dkv_mma": 0}
    for i, got in enumerate(res["launches"]):
        if got != want:
            raise AssertionError(f"training step {i} launched {got}, expected {want}")
    gen = torch.Generator().manual_seed(TRAIN["seed"])
    params = LCT.init_params(TRAIN["d_model"], TRAIN["d_ff"], generator=gen, device=dev)
    x, y = (a.to(dev) for a in LCT.train_data(TRAIN["seed"] + 1, TRAIN["b_loc"],
                                              TRAIN["t_loc"], TRAIN["d_model"]))
    leaves = {n: p.requires_grad_(True) for n, p in params.items()}
    pred = LCT.block_forward(leaves, x, heads=TRAIN["heads"], attend=lambda q, k, v:
                             TA.reference_attention(q, k, v, causal=True))
    loss = torch.mean((pred - y) ** 2)
    loss.backward()
    loss_rel = abs(losses[0] - loss.item()) / abs(loss.item())
    if loss_rel > LOSS_RTOL:
        raise AssertionError(f"first loss {losses[0]} != reference {loss.item()}")
    worst = 0.0
    for name, p in leaves.items():
        got = res["grads0"][name]
        err = ((got - p.grad).abs() / (TRAIN_GRAD_ATOL + TRAIN_GRAD_RTOL * p.grad.abs())).max().item()
        worst = max(worst, err)
        if err > 1:
            raise AssertionError(f"first-step gradient of {name} off the reference "
                                 f"step: {err:.3f} of the band")
    del leaves, pred, loss, params
    walls = res["wall"]
    step_s = float(np.median(walls[1:]))
    tokens = TRAIN["b_loc"] * TRAIN["t_loc"]
    print(f"training, 1 GPU (d_model {TRAIN['d_model']}, heads {TRAIN['heads']}, d_ff "
          f"{TRAIN['d_ff']}, B {TRAIN['b_loc']}, T {TRAIN['t_loc']}, lr {TRAIN['lr']}): "
          f"loss {losses[0]:.6f} -> {losses[-1]:.6f}; step walls "
          + ", ".join(f"{w:.4f}" for w in walls) + f" s; median {step_s * 1e3:.2f} ms "
          f"a step, {tokens / step_s:.0f} tokens/s; peak memory "
          f"{res['peak_bytes'] / 2**30:.2f} GiB; launches per step {res['launches'][0]}; "
          f"first step against reference_attention: loss rel diff "
          f"{loss_rel:.3e}, gradients at {worst:.3f} of the "
          f"band (rtol {TRAIN_GRAD_RTOL}, atol {TRAIN_GRAD_ATOL})")
    return {"losses": losses, "grads0": {n: g.cpu() for n, g in res["grads0"].items()},
            "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
            "peak_bytes": res["peak_bytes"], "walls": walls,
            "launches_per_step": res["launches"][0], "grad_band_share": worst}


def ring_training_launches(s):
    """Each flash kernel's launches a step on sp rank ``s`` of the (2,2)
    training: the earlier block forward 2s times (forward and the
    memory-efficient backward's recompute), the causal one twice, the
    backward kernels s + 1 times each."""
    return {"flash_fwd_tf32": 2 * s, "flash_fwd_causal_tf32": 2,
            "flash_bwd_dq_tf32": s + 1, "flash_bwd_dkv_tf32": s + 1,
            "flash_fwd_mma": 0, "flash_fwd_causal_mma": 0, "flash_bwd_dq_mma": 0,
            "flash_bwd_dkv_mma": 0}


def four_rank_training(LCT, launch, single, device):
    """The training example on four gloo ranks on this card, a (2,2) grid
    of (dp, sp): 2 rows x 2048 tokens a rank, the single-GPU problem cut
    into tiles.  Every rank ends every step with the same parameters; the
    first step's loss and gradients equal the single-GPU run's."""
    kwargs = {**TRAIN, "b_loc": ATTN_B // 2, "t_loc": ATTN_T // 2}
    t0 = time.perf_counter()
    ranks = launch.run(LCT.rank_main, 4, backend="gloo", device=device,
                       timeout=600, args=(device, kwargs))
    print(f"four ranks, training on a (2,2) grid: {time.perf_counter() - t0:.1f} s "
          "with start-up")
    r0 = ranks[0]
    for r, res in enumerate(ranks):
        if res["digests"] != r0["digests"] or res["losses"] != r0["losses"]:
            raise AssertionError(f"rank {r}'s parameters or losses differ from rank 0's")
        want = ring_training_launches(r % 2)
        for i, got in enumerate(res["launches"]):
            if got != want:
                raise AssertionError(f"rank {r} step {i} launched {got}, expected {want}")
    if abs(r0["losses"][0] - single["losses"][0]) > LOSS_RTOL * abs(single["losses"][0]):
        raise AssertionError(f"four-rank first loss {r0['losses'][0]} != single-GPU "
                             f"{single['losses'][0]}")
    worst = 0.0
    for name, ref in single["grads0"].items():
        got = torch.from_numpy(r0["grads0"][name])
        worst = max(worst, ((got - ref).abs() / (TRAIN_GRAD_ATOL + TRAIN_GRAD_RTOL
                                                  * ref.abs())).max().item())
    if worst > 1:
        raise AssertionError(f"four-rank first-step gradients at {worst:.3f} of the band")
    if not r0["losses"][-1] < r0["losses"][0]:
        raise AssertionError(f"four-rank training did not reduce the loss: {r0['losses']}")
    ex = r0["exchange"]
    for r, res in enumerate(ranks):
        print(f"  rank {r}: launches per step {res['launches'][0]}; peak memory "
              f"{res['peak_bytes'] / 2**30:.2f} GiB")
    print("four processes share one card (gloo, exchanges staged through host memory; "
          f"not a scaling result): rank 0 step walls "
          + ", ".join(f"{w:.4f}" for w in r0["wall"]) + " s, of which in exchanges "
          + ", ".join(f"{e['seconds']:.4f}" for e in ex) + f" s; per step "
          f"{ex[0]['calls']} exchanges, {ex[0]['staged_bytes'] / 1e6:.1f} MB staged; "
          f"first step at {worst:.3f} of the gradient band from the single-GPU run; "
          f"loss {r0['losses'][0]:.6f} -> {r0['losses'][-1]:.6f}")
    return {"walls_rank0": r0["wall"], "exchange_rank0": ex,
            "launches_per_step": [res["launches"][0] for res in ranks],
            "peak_bytes": [res["peak_bytes"] for res in ranks],
            "grad_band_share": worst, "losses": r0["losses"]}


def grad_rank(rank, device, b, t_loc, h, d, runs):
    """One of four ranks on ``device``: for each ``(scheme, causal)`` of
    ``runs``, the gradient of the sum over ranks of ``sum(out**2)`` for
    this rank's shards of the demo's q, k, v, against its slice of the
    single-GPU ``flash_attention`` gradient of the gathered sequence (and
    the forward against its output); the launches, exchanges and peak
    memory of the backward.  ``"ring_plain"`` is
    ``ring_attention(memory_efficient_grad=False)``."""
    from mpi4jax_tpu_torch import Comm, make_world_mesh
    from mpi4jax_tpu_torch.attention import (flash_attention, ring_attention,
                                             ulysses_attention)
    from mpi4jax_tpu_torch.kernels import _build
    from mpi4jax_tpu_torch.models import long_context_attention as LCA
    from mpi4jax_tpu_torch.ops import _staging

    dev = torch.device(device)
    n = 4
    world = Comm("sp", mesh=make_world_mesh((n,), ("sp",), device=dev))
    full = [torch.from_numpy(np.concatenate(list(x), axis=1)).to(dev)
            for x in LCA.demo_data(0, n, b, t_loc, h, d)]
    mine = slice(rank * t_loc, (rank + 1) * t_loc)
    fns = {"ring": ring_attention, "ulysses": ulysses_attention,
           "ring_plain": lambda *a, **k: ring_attention(*a, **k,
                                                        memory_efficient_grad=False)}
    kernels = ("flash_fwd_tf32", "flash_fwd_causal_tf32", "flash_bwd_dq_tf32",
               "flash_bwd_dkv_tf32", "flash_bwd_dq_mma", "flash_bwd_dkv_mma")
    out = {}
    for scheme, causal in runs:
        leaves = [x.clone().requires_grad_(True) for x in full]
        ref_out = flash_attention(*leaves, causal=causal)
        (ref_out ** 2).sum().backward()
        refs = [t.grad[:, mine] for t in leaves]
        ref_out = ref_out.detach()[:, mine]
        del leaves
        shards = [x[:, mine].clone().requires_grad_(True) for x in full]
        for name in kernels:
            _build.counter_for(name).launches = 0
        _staging.stats.reset()
        o = fns[scheme](*shards, comm=world, causal=causal)
        loss = (o ** 2).sum()
        torch.cuda.synchronize(dev)
        out_ok = bool(torch.isfinite(o).all()) and torch.allclose(
            o, ref_out, rtol=ATTN_RTOL, atol=ATTN_ATOL)
        out_err = (o - ref_out).abs().max().item()
        forward_calls, forward_s = _staging.stats.calls, _staging.stats.seconds
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - start
        errs, ok = [], True
        for a, r in zip(shards, refs):
            errs.append((a.grad - r).abs().max().item())
            ok = ok and bool(torch.isfinite(a.grad).all()) and torch.allclose(
                a.grad, r, rtol=GRAD_RTOL, atol=GRAD_ATOL)
        out[f"{scheme}/{'causal' if causal else 'full'}"] = {
            "launches": {k: _build.counter_for(k).launches for k in kernels},
            "errs": errs, "ok": ok, "wall_bwd": wall,
            "out_err": out_err, "out_ok": out_ok,
            "peak_bwd_bytes": torch.cuda.max_memory_allocated(dev) - base,
            "exchanges": (forward_calls, _staging.stats.calls - forward_calls),
            "exchange_s_bwd": _staging.stats.seconds - forward_s,
            "staged_bytes": _staging.stats.staged_bytes,
        }
        del shards, refs, loss, o, ref_out
    return out


def four_rank_grads(launch, device):
    """Ring (causal and not) and causal Ulysses gradients on four gloo ranks
    on this card at the attention width, 1024 tokens a rank; each rank
    against its slice of single-GPU ``flash_attention``'s gradients."""
    t_loc = ATTN_T // 4
    runs = (("ring", True), ("ring", False), ("ulysses", True))
    t0 = time.perf_counter()
    ranks = launch.run(grad_rank, 4, backend="gloo", device=device, timeout=600,
                       args=(device, ATTN_B, t_loc, ATTN_H, ATTN_D, runs))
    print(f"four ranks, attention gradients: {time.perf_counter() - t0:.1f} s with "
          "start-up")
    # forward + backward launches per rank r: (flash_fwd_tf32, flash_fwd_causal_tf32,
    # flash_bwd_dq_tf32, flash_bwd_dkv_tf32, and the bf16 flash_bwd_dq_mma,
    # flash_bwd_dkv_mma); the ring's backward recomputes every block's
    # forward, Ulysses' reuses the saved m
    expect = {"ring/causal": lambda r: (2 * r, 2, r + 1, r + 1, 0, 0),
              "ring/full": lambda r: (8, 0, 4, 4, 0, 0),
              "ulysses/causal": lambda r: (0, 1, 1, 1, 0, 0)}
    worst, launches = 0.0, {"flash_bwd_dq_tf32": 0, "flash_bwd_dkv_tf32": 0}
    for key, want in expect.items():
        for r, res in enumerate(ranks):
            run = res[key]
            got = tuple(run["launches"].values())
            if got != want(r):
                raise AssertionError(f"{key} rank {r}: launches {got}, expected {want(r)}")
            if not run["ok"]:
                raise AssertionError(f"{key} rank {r}: gradients off single-GPU "
                                     f"flash_attention's by {max(run['errs']):.3e}")
            for name in launches:
                launches[name] += run["launches"][name]
            worst = max(worst, *run["errs"])
            print(f"  {key} rank {r}: dq, dk, dv max|diff| "
                  + ", ".join(f"{e:.3e}" for e in run["errs"])
                  + f" from single-GPU flash_attention's; launches {got}; backward "
                  f"{run['wall_bwd']:.4f} s ({run['exchange_s_bwd']:.4f} s inside "
                  f"exchanges), peak {run['peak_bwd_bytes'] / 2**20:.1f} MiB "
                  f"above the forward's; exchanges (forward, backward) "
                  f"{run['exchanges']}, {run['staged_bytes'] / 1e6:.1f} MB staged")
    print("four processes share one card (gloo; not a scaling result)")
    return worst, launches, {key: {"wall_bwd_rank0": ranks[0][key]["wall_bwd"],
                                   "exchange_s_bwd_rank0": ranks[0][key]["exchange_s_bwd"],
                                   "peak_bwd_bytes_rank0": ranks[0][key]["peak_bwd_bytes"],
                                   "staged_bytes_rank0": ranks[0][key]["staged_bytes"]}
                             for key in expect}

# -- phase 8: the op surface, the op-by-op ring backward and the dry run ---

# the unequal split of phase 8: (0,) and (1, 2, 3)
SURFACE_COLORS = [0, 1, 1, 1]


def surface_inputs(n):
    """Every rank's inputs of phase 8, from a numpy seed: f32 ``f``
    (n, 256, 256) in [0.5, 1.5), int32 ``i``, bool ``b``, and int32
    ``blocks`` (n, n, 128, 128), block j addressed to rank j."""
    rng = np.random.default_rng(5)
    return {"f": rng.uniform(0.5, 1.5, (n, 256, 256)).astype(np.float32),
            "i": rng.integers(-1000, 1000, (n, 256, 256)).astype(np.int32),
            "b": rng.random((n, 256, 256)) < 0.5,
            "blocks": rng.integers(-1000, 1000, (n, n, 128, 128)).astype(np.int32)}


def butterfly(vals, fn):
    """The fold of ``vals`` in the association of the port's
    ``ops/_base.py:fold`` (the JAX package's doubling butterfly)."""
    acc, w = list(vals), 1
    while w < len(acc):
        acc = [fn(acc[p], acc[p + w]) if p + w < len(acc) else acc[p]
               for p in range(len(acc))]
        w *= 2
    return acc[0]


def hillis_steele(vals, fn):
    """The inclusive prefix of ``vals`` in ``ops/scan.py``'s rounds."""
    acc, d = list(vals), 1
    while d < len(acc):
        acc = [fn(acc[r], acc[r - d]) if r >= d else acc[r] for r in range(len(acc))]
        d *= 2
    return acc


def surface_cases(world, split, t, rank):
    """Phase 8's op calls on this rank's inputs ``t``, by name."""
    from mpi4jax_tpu_torch import (BAND, BOR, BXOR, LAND, LOR, LXOR, MAX, MIN,
                                   PROD, SUM, allgather, allreduce, alltoall,
                                   barrier, bcast, gather, recv, reduce,
                                   reduce_scatter, scan, scatter, send, sendrecv,
                                   shift)

    def pair(x, dest, tag, comm):
        send(x, dest, tag=tag, comm=comm)
        return recv(x, tag=tag, comm=comm)

    cases = {f"allreduce/{k}/{op.name}": (lambda k=k, op=op:
                                          allreduce(t[k], op, comm=world))
             for k, ops in (("f", (SUM, PROD, MIN, MAX)), ("i", (SUM, BAND, BOR, BXOR)),
                            ("b", (LAND, LOR, LXOR))) for op in ops}
    cases.update({
        **{f"allgather/{k}": (lambda k=k: allgather(t[k], comm=world)) for k in "fib"},
        "bcast/i/2": lambda: bcast(t["i"], 2, comm=world),
        "bcast/b/1": lambda: bcast(t["b"], 1, comm=world),
        "reduce/i/SUM/1": lambda: reduce(t["i"], SUM, 1, comm=world),
        "reduce/f/MAX/3": lambda: reduce(t["f"], MAX, 3, comm=world),
        "reduce_scatter/SUM": lambda: reduce_scatter(t["blocks"], SUM, comm=world),
        "reduce_scatter/BXOR": lambda: reduce_scatter(t["blocks"], BXOR, comm=world),
        "scan/f/SUM": lambda: scan(t["f"], SUM, comm=world),
        "scan/i/SUM": lambda: scan(t["i"], SUM, comm=world),
        "scatter/3": lambda: scatter(t["blocks"], 3, comm=world),
        "gather/f/0": lambda: gather(t["f"], 0, comm=world),
        "alltoall": lambda: alltoall(t["blocks"], comm=world),
        "sendrecv": lambda: sendrecv(t["f"], t["f"], dest=shift(1), comm=world),
        "send_recv": lambda: pair(t["f"], shift(-1), 5, world),
        "barrier": lambda: (None, barrier(comm=world)),
        "split/allreduce/i/SUM": lambda: allreduce(t["i"], SUM, comm=split),
        "split/allreduce/f/PROD": lambda: allreduce(t["f"], PROD, comm=split),
        "split/scan/i/SUM": lambda: scan(t["i"], SUM, comm=split),
        "split/bcast/f/0": lambda: bcast(t["f"], 0, comm=split),
        "split/reduce/i/SUM/0": lambda: reduce(t["i"], SUM, 0, comm=split),
        "split/sendrecv": lambda: sendrecv(t["f"], t["f"], dest=shift(1), comm=split),
        "split/send_recv": lambda: pair(t["f"], shift(1), 2, split),
    })

    def grad_of(fn, x):
        x = x.clone().requires_grad_(True)
        fn(x).backward()
        return (x.grad, None)

    w = float(rank + 1)  # this rank's loss weight
    cases.update({
        "grad/allreduce": lambda: grad_of(
            lambda x: allreduce(x, SUM, comm=world)[0].sum() * w, t["f"]),
        "grad/bcast": lambda: grad_of(
            lambda x: bcast(x, 0, comm=world)[0].sum() * w, t["f"]),
        "grad/sendrecv": lambda: grad_of(
            lambda x: sendrecv(x, x, dest=shift(1), comm=world)[0].sum() * w, t["f"]),
        "grad/reduce_scatter": lambda: grad_of(
            lambda x: reduce_scatter(x, SUM, comm=world)[0].sum() * w,
            t["blocks"].float()),
    })
    return cases


def surface_expected(inp, n):
    """Every rank's expected result of each phase-8 case, computed in numpy."""
    f, i, b, blocks = inp["f"], inp["i"], inp["b"], inp["blocks"]
    ranks = range(n)
    allr = lambda x, fn: [butterfly(list(x), fn)] * n  # noqa: E731
    groups = [[0], [1, 2, 3]]
    group_of = {r: g for g in groups for r in g}
    want = {
        "allreduce/f/SUM": [f.sum(0)] * n,
        "allreduce/f/PROD": allr(f, np.multiply),
        "allreduce/f/MIN": [f.min(0)] * n, "allreduce/f/MAX": [f.max(0)] * n,
        "allreduce/i/SUM": [i.sum(0, dtype=np.int32)] * n,
        "allreduce/i/BAND": allr(i, np.bitwise_and),
        "allreduce/i/BOR": allr(i, np.bitwise_or),
        "allreduce/i/BXOR": allr(i, np.bitwise_xor),
        "allreduce/b/LAND": allr(b, np.logical_and),
        "allreduce/b/LOR": allr(b, np.logical_or),
        "allreduce/b/LXOR": allr(b, np.logical_xor),
        "allgather/f": [f] * n, "allgather/i": [i] * n, "allgather/b": [b] * n,
        "bcast/i/2": [i[2]] * n, "bcast/b/1": [b[1]] * n,
        "reduce/i/SUM/1": [i.sum(0, dtype=np.int32) if r == 1 else i[r] for r in ranks],
        "reduce/f/MAX/3": [f.max(0) if r == 3 else f[r] for r in ranks],
        "reduce_scatter/SUM": [blocks[:, r].sum(0, dtype=np.int32) for r in ranks],
        "reduce_scatter/BXOR": [butterfly(list(blocks[:, r]), np.bitwise_xor)
                                for r in ranks],
        "scan/f/SUM": hillis_steele(list(f), np.add),
        "scan/i/SUM": hillis_steele(list(i), np.add),
        "scatter/3": [blocks[3, r] for r in ranks],
        "gather/f/0": [f] * n,
        "alltoall": [blocks[:, r] for r in ranks],
        "sendrecv": [f[(r - 1) % n] for r in ranks],
        "send_recv": [f[(r + 1) % n] for r in ranks],
        "split/allreduce/i/SUM": [i[group_of[r]].sum(0, dtype=np.int32) for r in ranks],
        "split/allreduce/f/PROD": [butterfly(list(f[group_of[r]]), np.multiply)
                                   for r in ranks],
        "split/scan/i/SUM": [hillis_steele(list(i[group_of[r]]), np.add)[
            group_of[r].index(r)] for r in ranks],
        "split/bcast/f/0": [f[group_of[r][0]] for r in ranks],
        "split/reduce/i/SUM/0": [i[group_of[r]].sum(0, dtype=np.int32)
                                 if r == group_of[r][0] else i[r] for r in ranks],
        "split/sendrecv": [f[group_of[r][(group_of[r].index(r) - 1) % len(group_of[r])]]
                           for r in ranks],
        "split/send_recv": [f[group_of[r][(group_of[r].index(r) - 1) % len(group_of[r])]]
                            for r in ranks],
        # rank r's loss weight is r + 1: the SUM allreduce's backward is the
        # identity, bcast's sums every weight onto root, sendrecv's takes the
        # weight of the rank it sent to, reduce_scatter's is the allgather
        "grad/allreduce": [np.full_like(f[0], r + 1) for r in ranks],
        "grad/bcast": [np.full_like(f[0], sum(range(1, n + 1)) if r == 0 else 0)
                       for r in ranks],
        "grad/sendrecv": [np.full_like(f[0], (r + 1) % n + 1) for r in ranks],
        "grad/reduce_scatter": [np.stack([np.full(blocks.shape[2:], j + 1, np.float32)
                                          for j in ranks]) for r in ranks],
    }
    return want


def surface_rank(rank, device, b, t_loc, h, d):
    """One of four ranks of phase 8 on ``device``: every op of the surface
    on CUDA tensors (the world and an unequal split), each call's wall and
    staged bytes, then the op-by-op ring backward (``grad_rank``)."""
    from mpi4jax_tpu_torch import Comm, flush, make_world_mesh
    from mpi4jax_tpu_torch.ops import _staging

    dev = torch.device(device)
    n = 4
    world = Comm("x", mesh=make_world_mesh((n,), ("x",), device=dev))
    split = world.Split(SURFACE_COLORS)
    t = {k: torch.from_numpy(v[rank]).to(dev) for k, v in surface_inputs(n).items()}
    out = {"results": {}, "wall": {}, "staged": {}}
    # twice, keeping the second: a call's first use in a process pays for
    # loading its code and setting up its gloo algorithm
    for _ in range(2):
        for name, fn in surface_cases(world, split, t, rank).items():
            torch.cuda.synchronize(dev)
            staged, start = _staging.stats.staged_bytes, time.perf_counter()
            res = fn()[0]
            torch.cuda.synchronize(dev)
            out["wall"][name] = time.perf_counter() - start
            out["staged"][name] = _staging.stats.staged_bytes - staged
            if res is not None:
                if res.device != dev:
                    raise AssertionError(f"{name}: result on {res.device}, not {dev}")
                out["results"][name] = res
    flush()
    # both backward paths, twice, keeping the second (see above)
    runs = (("ring", True), ("ring", False), ("ring_plain", True), ("ring_plain", False))
    out["ring"] = grad_rank(rank, device, b, t_loc, h, d, runs * 2)
    return out


def four_rank_surface(launch, device, me_runs):
    """Phase 8: four gloo ranks on this card.  Every op on CUDA tensors
    against numpy, bit for bit but for the f32 SUM and PROD allreduce on
    the world (one ``dist.all_reduce``, whose association is the
    backend's: rtol 1e-5, tests/test_allreduce.py:62);
    ``ring_attention(memory_efficient_grad=False)`` at the attention width,
    causal and not, each rank's output and gradients against its slice of
    single-GPU ``flash_attention``'s with the launches of the four f32
    kernels checked, its backward beside the memory-efficient one run in
    the same processes and beside phase 6's (``me_runs``); then
    ``entry.dryrun_multichip(4)`` on this card, its kernels' launches per
    rank and their checks against their plain versions.  Returns the
    op-by-op runs' worst difference, their launches, the dry run's
    launches and worst difference per kernel, each run's numbers and the
    ops' numbers."""
    n, t_loc = 4, ATTN_T // 4
    t0 = time.perf_counter()
    ranks = launch.run(surface_rank, n, backend="gloo", device=device, timeout=600,
                       args=(device, ATTN_B, t_loc, ATTN_H, ATTN_D))
    print(f"four ranks, op surface and op-by-op ring backward: "
          f"{time.perf_counter() - t0:.1f} s with start-up")
    want = surface_expected(surface_inputs(n), n)
    for name, per_rank in want.items():
        for r, res in enumerate(ranks):
            got, exp = res["results"][name], np.asarray(per_rank[r])
            if name in ("allreduce/f/SUM", "allreduce/f/PROD"):
                ok = got.shape == exp.shape and np.allclose(got, exp, rtol=1e-5, atol=0)
            else:
                ok = got.dtype == exp.dtype and np.array_equal(got, exp)
            if not ok:
                raise AssertionError(f"{name} rank {r}: differs from numpy "
                                     f"({got.dtype} {got.shape} vs {exp.dtype} "
                                     f"{exp.shape})")
    r0 = ranks[0]
    print("  every op on CUDA tensors against numpy (rank 0: wall ms, staged MB): "
          + ", ".join(f"{k} {r0['wall'][k] * 1e3:.3f} ms {r0['staged'][k] / 1e6:.2f} MB"
                      for k in r0["wall"]))
    # launches per rank r (flash_fwd_tf32, flash_fwd_causal_tf32,
    # flash_bwd_dq_tf32, flash_bwd_dkv_tf32, flash_bwd_dq_mma,
    # flash_bwd_dkv_mma): the op-by-op backward reuses every block's saved
    # partials and recomputes no forward; the memory-efficient one, timed
    # beside it in this phase, recomputes each computed block's forward
    expect = {"ring_plain/causal": lambda r: (r, 1, r + 1, r + 1, 0, 0),
              "ring_plain/full": lambda r: (4, 0, 4, 4, 0, 0),
              "ring/causal": lambda r: (2 * r, 2, r + 1, r + 1, 0, 0),
              "ring/full": lambda r: (8, 0, 4, 4, 0, 0)}
    worst = 0.0
    launches = dict.fromkeys(("flash_fwd_tf32", "flash_fwd_causal_tf32",
                              "flash_bwd_dq_tf32", "flash_bwd_dkv_tf32"), 0)
    for key, expected in expect.items():
        for r, res in enumerate(ranks):
            run = res["ring"][key]
            got = tuple(run["launches"].values())
            if got != expected(r):
                raise AssertionError(f"{key} rank {r}: launches {got}, "
                                     f"expected {expected(r)}")
            if not run["out_ok"]:
                raise AssertionError(f"{key} rank {r}: output off single-GPU "
                                     f"flash_attention's by {run['out_err']:.3e}")
            if not run["ok"]:
                raise AssertionError(f"{key} rank {r}: gradients off single-GPU "
                                     f"flash_attention's by {max(run['errs']):.3e}")
            if key.startswith("ring_plain"):
                for name in launches:
                    launches[name] += run["launches"][name]
                worst = max(worst, run["out_err"], *run["errs"])
            print(f"  {key} rank {r}: out max|diff| {run['out_err']:.3e}, dq, dk, dv "
                  + ", ".join(f"{e:.3e}" for e in run["errs"])
                  + f"; launches {got}; backward {run['wall_bwd']:.4f} s "
                  f"({run['exchange_s_bwd']:.4f} s inside exchanges), peak "
                  f"{run['peak_bwd_bytes'] / 2**20:.1f} MiB above the forward's; "
                  f"exchanges (forward, backward) {run['exchanges']}")
    for causal in ("causal", "full"):
        plain, me = (ranks[0]["ring"][f"{k}/{causal}"] for k in ("ring_plain", "ring"))
        me6 = me_runs[f"ring/{causal}"]
        print(f"  ring {causal} rank 0 backward: op by op {plain['wall_bwd']:.4f} s, "
              f"{plain['exchange_s_bwd']:.4f} s in exchanges, peak "
              f"{plain['peak_bwd_bytes'] / 2**20:.1f} MiB above the forward's; "
              f"memory-efficient {me['wall_bwd']:.4f} s, {me['exchange_s_bwd']:.4f} s, "
              f"{me['peak_bwd_bytes'] / 2**20:.1f} MiB (phase 6, its first call in "
              f"its processes: {me6['wall_bwd_rank0']:.4f} s, "
              f"{me6['exchange_s_bwd_rank0']:.4f} s, "
              f"{me6['peak_bwd_bytes_rank0'] / 2**20:.1f} MiB)")
    print("four processes share one card (gloo; not a scaling result)")

    from mpi4jax_tpu_torch.entry import dryrun_multichip

    t0 = time.perf_counter()
    dry = dryrun_multichip(4, device=device, timeout=600)
    print(f"dryrun_multichip(4, {device}): {time.perf_counter() - t0:.1f} s with "
          f"start-up; checks {json.dumps(dry['checks'], default=str)}")
    # the f32 flash launches per rank r of the dry run's causal ring (two
    # forwards and the memory-efficient backward; t_loc 8, one block a
    # step): (flash_fwd_tf32, flash_fwd_causal_tf32, flash_bwd_dq_tf32,
    # flash_bwd_dkv_tf32) = (3 r, 3, r + 1, r + 1)
    for r, res in enumerate(dry["ranks"]):
        got = tuple(res["launches"][k] for k in launches)
        if got != (3 * r, 3, r + 1, r + 1):
            raise AssertionError(f"dry run rank {r}: f32 flash launches {got}, "
                                 f"expected {(3 * r, 3, r + 1, r + 1)}")
    held = dry["checks"]["kernels_vs_plain"]
    dry_kernels = {name: {"launches": n, "max_abs_err": held[name]["max_abs_err"]}
                   for name, n in dry["checks"]["kernel_launches"]["launches"].items()}
    print("  dry run, launches over the four ranks and max|diff| from plain at its "
          "shapes: " + ", ".join(f"{k} {v['launches']} ({v['max_abs_err']:.3e})"
                                 for k, v in dry_kernels.items()))
    runs = {key: {"wall_bwd_rank0": ranks[0]["ring"][key]["wall_bwd"],
                  "launches_per_rank": [tuple(r["ring"][key]["launches"].values())
                                        for r in ranks],
                  "exchange_s_bwd_rank0": ranks[0]["ring"][key]["exchange_s_bwd"],
                  "peak_bwd_bytes_rank0": ranks[0]["ring"][key]["peak_bwd_bytes"],
                  "staged_bytes_rank0": ranks[0]["ring"][key]["staged_bytes"]}
            for key in expect}
    return worst, launches, dry_kernels, runs, {"op_wall_ms_rank0": {
        k: v * 1e3 for k, v in ranks[0]["wall"].items()},
        "op_staged_bytes_rank0": ranks[0]["staged"], "dryrun_checks": dry["checks"]}


# -- phase 9: data-parallel training and the throughput layer ---------------

# the DP example's runs: (codec, fusion); the first is the exact run the
# others' loss curves are held against
DP_RUNS = (("off", "auto"), ("bf16", "auto"), ("fp8", "auto"), ("off", "off"))
DP_STEPS, DP_WARMUP = 200, 10
# loss-curve parity per codec: the largest |loss - exact loss| / exact loss
# after the warm-up (benchmarks/compress_replay.py:89)
PARITY_TOL = {"bf16": 2e-2, "fp8": 1e-1}
# 5 DP steps against single-device SGD (tests/test_data_parallel.py:82-84)
SGD_RTOL, SGD_ATOL = 5e-5, 1e-6
# fused against unfused f32 SUMs (the band of tests/test_allreduce.py:62,
# with a floor of 1e-6 of the tensor's largest value for cancellations)
SUM_RTOL, SUM_FLOOR = 1e-5, 1e-6
FUSION_MODES = ("off", "auto", "force")
# gradient collectives a step of the (2,2) training at full width: the
# loss (4 B), w1 and w2 (8 MiB), wo (4 MiB), wout (4 KiB), wqkv (12 MiB)
# under the 4 MiB bucket cap (ops/_fusion.py:bucket_plan)
FUSION_PLANS = {"off": 6, "auto": 6, "force": 1}


def sum_band(got, ref):
    """The largest ``|got - ref|`` over its bound, ``SUM_RTOL |ref|`` plus
    ``SUM_FLOOR max|ref|``: 1 is the edge of the band."""
    lim = SUM_RTOL * ref.abs() + SUM_FLOOR * ref.abs().max()
    return ((got - ref).abs() / lim).max().item()


def overlap_timing(comm, payload, q, reps=5):
    """Rank's walls (median of ``reps`` after one) of the gradient set's
    allreduces then one f32 causal flash forward, against the starts, the
    same forward, then the waits; each form's results and the largest
    band share of the second's against the first's."""
    from mpi4jax_tpu_torch import (SUM, allreduce, allreduce_start, allreduce_wait,
                                   spmd)
    from mpi4jax_tpu_torch.attention import flash_attention
    from mpi4jax_tpu_torch.ops import _staging

    dev = q.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else lambda d: None

    @spmd(comm=comm)
    def plain():
        red = [allreduce(g, op=SUM)[0] for g in payload]
        return red, flash_attention(q, q, q, causal=True)

    @spmd(comm=comm)
    def started():
        handles = [allreduce_start(g, op=SUM)[0] for g in payload]
        o = flash_attention(q, q, q, causal=True)  # overlaps the exchanges
        return [allreduce_wait(h)[0] for h in handles], o

    @spmd(comm=comm)
    def compute():
        return flash_attention(q, q, q, causal=True)

    walls = {"allreduce_then_compute": [], "start_compute_wait": [], "compute": []}
    exch = {"allreduce_then_compute": [], "start_compute_wait": []}
    outs = {}
    for _ in range(reps + 1):
        for name, fn in (("allreduce_then_compute", plain),
                         ("start_compute_wait", started), ("compute", compute)):
            sync(dev)
            _staging.stats.reset()
            t0 = time.perf_counter()
            outs[name] = fn()
            sync(dev)
            walls[name].append(time.perf_counter() - t0)
            if name in exch:
                exch[name].append(_staging.stats.seconds)
    share = max(sum_band(a, b) for a, b in zip(outs["start_compute_wait"][0],
                                                outs["allreduce_then_compute"][0]))
    if share > 1 or not torch.equal(outs["start_compute_wait"][1],
                                    outs["allreduce_then_compute"][1]):
        raise AssertionError(f"start/wait off the plain allreduce: {share:.3f} of "
                             "the band")
    return ({k: float(np.median(v[1:])) for k, v in walls.items()},
            {k: float(np.median(v[1:])) for k, v in exch.items()}, share)


def codec_on_card(grads):
    """``encode_fp8``, ``decode_fp8`` and both roundtrips of each gradient
    on the card against the same calls on the CPU, bit for bit; returns
    how many elements were held."""
    from mpi4jax_tpu_torch.ops import _compress as Z

    held = 0
    for name, g in grads.items():
        cpu = g.detach().cpu()
        (q, s), (qc, sc) = Z.encode_fp8(g), Z.encode_fp8(cpu)
        same = (torch.equal(q.cpu().view(torch.uint8), qc.view(torch.uint8))
                and torch.equal(s.cpu().view(torch.int32), sc.view(torch.int32))
                and torch.equal(Z.decode_fp8(q, s, g.shape, g.numel()).cpu()
                                .view(torch.int32),
                                Z.decode_fp8(qc, sc, cpu.shape, cpu.numel())
                                .view(torch.int32)))
        for codec in ("bf16", "fp8"):
            same = same and torch.equal(Z.roundtrip(g, codec).cpu().view(torch.int32),
                                        Z.roundtrip(cpu, codec).view(torch.int32))
        if not same:
            raise AssertionError(f"codec of {name}: CUDA differs from the CPU")
        held += g.numel()
    return held


def throughput_rank(rank, device, lct_kwargs):
    """One of four ranks of phase 9 on ``device``: the DP example under
    each (codec, fusion) of ``DP_RUNS`` and 5 steps against single-device
    SGD; the (2, 2) training under each fusion mode; the fusion demo and
    the overlap timing; the codec on the card against the CPU."""
    from mpi4jax_tpu_torch import Comm, make_world_mesh
    from mpi4jax_tpu_torch.models import data_parallel_training as DP
    from mpi4jax_tpu_torch.models import fusion_overlap_demo as FD
    from mpi4jax_tpu_torch.models import long_context_training as LCT
    from mpi4jax_tpu_torch.utils.tree import tree_leaves

    dev = torch.device(device)
    out = {"dp": {}, "lct": {}}
    for codec, fusion in DP_RUNS:
        os.environ["MPI4JAX_TPU_COMPRESS"] = codec
        res = DP.main(steps=DP_STEPS, seed=0, device=device, fusion=fusion)
        out["dp"][f"{codec}/{fusion}"] = {k: res[k] for k in ("losses", "wall",
                                                               "exchange")}
    del os.environ["MPI4JAX_TPU_COMPRESS"]
    res = DP.main(steps=5, seed=0, device=device)
    x, y = (torch.from_numpy(a).to(dev) for a in DP.train_data(0, 4))
    ref = DP.sgd_steps(res["params0"], x.reshape(-1, 16), y.reshape(-1, 1), 5, DP.LR)
    errs = [((p - r).abs() / (SGD_ATOL + SGD_RTOL * r.abs())).max().item()
            for p, r in zip(tree_leaves(res["params"]), tree_leaves(ref))]
    out["dp_vs_sgd"] = max(errs)
    # off, auto, force, force, auto, off: each mode's walls on both sides
    # of the others' (host-staged walls drift within a process)
    grads0 = {}
    for mode in FUSION_MODES + FUSION_MODES[::-1]:
        run = LCT.main(device, fusion=mode, **lct_kwargs)
        grads0.setdefault(mode, run.pop("grads0"))
        out["lct"].setdefault(mode, []).append(run)
    out["lct_band"] = {mode: max(sum_band(grads0[mode][n], g)
                                 for n, g in grads0["off"].items())
                       for mode in ("auto", "force")}
    out["codec_elements"] = codec_on_card(grads0["off"])
    out["demo"] = FD.main(device)
    comm = Comm("x", mesh=make_world_mesh((4,), ("x",), device=dev))
    gen = torch.Generator().manual_seed(rank)
    shapes = LCT.param_shapes(lct_kwargs["d_model"], lct_kwargs["d_ff"])
    payload = [torch.randn(shapes[n], generator=gen).to(dev) for n in sorted(shapes)]
    q = torch.randn((lct_kwargs["b_loc"], lct_kwargs["t_loc"], lct_kwargs["heads"],
                     lct_kwargs["d_model"] // lct_kwargs["heads"]),
                    generator=gen).to(dev)
    out["overlap"] = overlap_timing(comm, payload, q)
    return out


def four_rank_throughput(launch, device, lct_kwargs):
    """Phase 9 on four gloo ranks on this card (``throughput_rank``) with
    the (2,2) training at ``lct_kwargs``, its checks and its numbers;
    returns the summary for the kernels line."""
    from mpi4jax_tpu_torch.models import long_context_training as LCT
    from mpi4jax_tpu_torch.ops._fusion import bucket_plan

    t0 = time.perf_counter()
    ranks = launch.run(throughput_rank, 4, backend="gloo", device=device, timeout=900,
                       args=(device, lct_kwargs))
    print(f"four ranks, data-parallel training and the throughput layer: "
          f"{time.perf_counter() - t0:.1f} s with start-up")
    r0 = ranks[0]
    summary = {"dp": {}, "lct": {}}
    exact = r0["dp"]["off/auto"]["losses"]
    for key, run in r0["dp"].items():
        codec, fusion = key.split("/")
        calls = {e["calls"] for r in ranks for e in r["dp"][key]["exchange"]}
        if calls != {1 if fusion == "auto" else 5}:
            raise AssertionError(f"DP {key}: exchanges a step {calls}")
        gap = max(abs(a - b) / max(b, 1e-12)
                  for a, b in zip(run["losses"][DP_WARMUP:], exact[DP_WARMUP:]))
        if codec in PARITY_TOL and gap > PARITY_TOL[codec]:
            raise AssertionError(f"DP {key}: loss curve {gap:.3e} from the exact "
                                 f"run's, limit {PARITY_TOL[codec]}")
        if not run["losses"][-1] < run["losses"][0]:
            raise AssertionError(f"DP {key}: the loss did not fall")
        walls, ex = run["wall"][1:], run["exchange"][1:]
        summary["dp"][key] = {
            "wall_ms_per_step": float(np.median(walls)) * 1e3,
            "exchange_ms_per_step": float(np.median([e["seconds"] for e in ex])) * 1e3,
            "staged_bytes_per_step": ex[0]["staged_bytes"],
            "exchanges_per_step": ex[0]["calls"], "loss_gap": gap,
            "loss_first_last": (run["losses"][0], run["losses"][-1])}
    worst_sgd = max(r["dp_vs_sgd"] for r in ranks)
    if worst_sgd > 1:
        raise AssertionError(f"5 DP steps off single-device SGD: {worst_sgd:.3f} of "
                             "the band")
    print(f"  DP example (16 -> 64 -> 1, 64 rows a rank, {DP_STEPS} steps), rank 0 "
          "medians after the first step: " + "; ".join(
              f"{k}: {v['wall_ms_per_step']:.3f} ms a step, "
              f"{v['exchange_ms_per_step']:.3f} ms in {v['exchanges_per_step']} "
              f"exchange(s), {v['staged_bytes_per_step']} B staged, loss "
              f"{v['loss_first_last'][0]:.5f} -> {v['loss_first_last'][1]:.5f}, gap "
              f"to exact {v['loss_gap']:.3e}" for k, v in summary["dp"].items())
          + f"; 5 steps against single-device SGD at {worst_sgd:.3f} of the band")
    shapes = LCT.param_shapes(lct_kwargs["d_model"], lct_kwargs["d_ff"])
    entries = [("float32", 4)] + [("float32", 4 * int(np.prod(shapes[n])))
                                  for n in sorted(shapes)]
    plans = {"off": 6, "auto": len(bucket_plan(entries, 4 << 20)),
             "force": len(bucket_plan(entries, 4 << 20, force=True))}
    if plans != FUSION_PLANS:
        raise AssertionError(f"bucket plans {plans}, expected {FUSION_PLANS}")
    ring = 8  # the ring's rotations a step over sp (2 ranks): 4 (n - 1) + 2 n
    for mode in FUSION_MODES:
        for r, res in enumerate(ranks):
            for k, run in enumerate(res["lct"][mode]):
                want = ring_training_launches(r % 2)
                for i, got in enumerate(run["launches"]):
                    if got != want:
                        raise AssertionError(f"{mode} rank {r} step {i} launched {got}")
                calls = {e["calls"] for e in run["exchange"]}
                if calls != {ring + plans[mode]}:
                    raise AssertionError(f"{mode} rank {r}: exchanges a step {calls}, "
                                         f"expected {ring} + {plans[mode]}")
                if run["digests"] != ranks[0]["lct"][mode][k]["digests"]:
                    raise AssertionError(f"{mode} rank {r}: parameters differ from "
                                         "rank 0's")
        runs = r0["lct"][mode]
        summary["lct"][mode] = {
            "collectives_per_step": plans[mode],
            # each run's median of its steps after the first, in run order
            "wall_ms_median": [float(np.median(run["wall"][1:])) * 1e3 for run in runs],
            "exchange_ms_median": [float(np.median([e["seconds"] for e in
                                                    run["exchange"][1:]])) * 1e3
                                   for run in runs],
            "staged_bytes_per_step": runs[0]["exchange"][0]["staged_bytes"],
            "losses": runs[0]["losses"],
            "launches_per_step": [res["lct"][mode][0]["launches"][0] for res in ranks]}
    band = {m: max(r["lct_band"][m] for r in ranks) for m in ("auto", "force")}
    if max(band.values()) > 1:
        raise AssertionError(f"fused first gradients off the unfused: {band}")
    print(f"  (2,2) training at d_model {lct_kwargs['d_model']}, d_ff "
          f"{lct_kwargs['d_ff']}, {lct_kwargs['b_loc']} x {lct_kwargs['t_loc']} tokens "
          f"a rank, {lct_kwargs['steps']} steps a run, runs off, auto, force, force, "
          "auto, off; rank 0 medians after the first step, each mode's two runs: "
          + "; ".join(
              f"fusion {m}: {v['collectives_per_step']} gradient collective(s) a "
              f"step, " + " and ".join(f"{w:.2f}" for w in v["wall_ms_median"])
              + " ms a step, " + " and ".join(f"{e:.2f}" for e in
                                                v["exchange_ms_median"])
              + f" ms in exchanges, {v['staged_bytes_per_step'] / 1e6:.1f} MB staged"
              for m, v in summary["lct"].items())
          + "; first gradients against fusion off at "
          + ", ".join(f"{m} {b:.3f}" for m, b in band.items()) + " of the f32 SUM band")
    for r, res in enumerate(ranks):
        demo = res["demo"]
        if (demo["fused/auto/calls"], demo["fused/off/calls"]) != (1, 16):
            raise AssertionError(f"demo rank {r}: {demo['fused/auto/calls']} packed "
                                 f"collectives for 16 ({demo['fused/off/calls']})")
    walls, exch, share = r0["overlap"]
    print(f"  fusion demo on four ranks: 16 allreduces in 1 packed collective, "
          f"start/wait and overlap() equal to the plain allreduce; overlap, rank 0, "
          f"the gradient set ({sum(4 * int(np.prod(s)) for s in shapes.values()) / 1e6:.1f} "
          f"MB in 5 allreduces) and one f32 causal flash forward ({lct_kwargs['b_loc']}, "
          f"{lct_kwargs['t_loc']}, {lct_kwargs['heads']}, "
          f"{lct_kwargs['d_model'] // lct_kwargs['heads']}): allreduce then compute "
          f"{walls['allreduce_then_compute'] * 1e3:.2f} ms "
          f"({exch['allreduce_then_compute'] * 1e3:.2f} in exchanges), start, compute, "
          f"wait {walls['start_compute_wait'] * 1e3:.2f} ms "
          f"({exch['start_compute_wait'] * 1e3:.2f}), the compute alone "
          f"{walls['compute'] * 1e3:.2f} ms; results at {share:.3f} of the band")
    elements = min(r["codec_elements"] for r in ranks)
    print(f"  fp8 and bf16 codec on the card against the CPU, bit for bit: "
          f"{elements} elements of the first gradients a rank")
    print("four processes share one card (gloo, exchanges staged through host memory; "
          "not a scaling result); compression shrinks no bytes here (no multi-host "
          "lowering yet)")
    summary.update(dp_vs_sgd_band_share=worst_sgd, fused_grad_band_share=band,
                   overlap_ms_rank0={k: v * 1e3 for k, v in walls.items()},
                   overlap_exchange_ms_rank0={k: v * 1e3 for k, v in exch.items()},
                   codec_elements_held=elements)
    return summary


# phase 11: the runtime services.  The one-GPU solves run each tier once;
# the four-rank runs interleave the tiers in the same processes, so that
# no tier is compared with another call's numbers
RUNTIME_TIERS = ("off", "counters", "events")
# the four ranks' tiers, run in turn in the same processes: off first and
# last (the spread), counters and events between
RUNTIME_INTERLEAVED = ("off", "counters", "events", "off")
RUNTIME_HALO_STEPS = 20
# the four-rank tiers' wide2 solve: 0.02 simulated days (91 steps), the
# 0.1-day solve's depth cut to keep the smoke run in its time limit
RUNTIME_FOUR_RANK_DAYS = 0.02
# the split-phase step on one GPU: five boundary refreshes (h, u, v, then u
# and v after the viscosity phase), each a sendrecv onto itself in the two
# periodic x directions; on (2,2) four directions
SENDRECV_A_STEP = {1: 10, 4: 20}
# host us a call of the generic step read by phase 10 before the runtime
# services existed (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 5)
BEFORE_SERVICES_HOST_US = {"eager_spmd": 65.20, "pinned": 48.22, "pinned_donated": 26.73}
DRILL_TIMEOUT_S, DRILL_DELAY_S, DRILL_HANG_S = 1.0, 0.5, 3.0


def _pending_journal():
    from mpi4jax_tpu_torch.telemetry import journal

    return sum(len(d) for d in journal._journal.pending.values())


def _sendrecv(snap):
    calls = sum(r["calls"] for r in snap["ops"].values() if r["op"] == "sendrecv")
    records = sum(1 for e in snap.get("events", ()) if e.get("op") == "sendrecv")
    return calls, records


def runtime_solves(P, dev, t1):
    """One GPU, 3600x1800, 0.1 day: the periodic (``fast="auto"``) and the
    split-phase (``fast="pallas_halo"``) solves, ``pinned=True``, under
    each telemetry tier: each final state bit for bit with ``off``'s, 221
    ``sw_steps`` or 882 ``sw_phase`` launches a run; under ``counters``
    the pin kept its graph and counted ``sendrecv`` per replay (10 a step
    on the split-phase path, read from the snapshot); under ``events``
    the pin ran eagerly (the knob named), with one journal record a
    ``sendrecv`` and no begin left unpaired."""
    from mpi4jax_tpu_torch import telemetry
    from mpi4jax_tpu_torch.kernels import _build

    out = {}
    for label, fast, name, per_run, a_step in (
            ("periodic", "auto", "sw_steps", 221, 0),
            ("split_phase", "pallas_halo", "sw_phase", 882, SENDRECV_A_STEP[1])):
        cfg = P.Config(nx=3600, ny=1800)
        counter = _build.counter_for(name)
        ref, rows = None, {}
        for mode in RUNTIME_TIERS:
            telemetry.reset()
            telemetry.set_telemetry_mode(mode)
            try:
                info = {}
                counter.launches = 0
                wall, n, final = P.solve_fused(cfg, t1, device=dev, fast=fast,
                                               pinned=True, return_state=True,
                                               info=info)
                torch.cuda.synchronize()
                snap = telemetry.snapshot(include_events=True)
                pending = _pending_journal()
            finally:
                telemetry.set_telemetry_mode(None)
            calls, records = _sendrecv(snap)
            runs = info["runs"]
            want = a_step * n * runs
            print(f"{label}, telemetry {mode}: {n / wall:.2f} steps/s, graph "
                  f"{info['pinned']} ({info.get('eager_reason') or 'no per-op hook'}), "
                  f"{info['launches'].get(name, 0)} {name} launches a run, "
                  f"{counter.launches} over {runs} runs, sendrecv counted {calls} "
                  f"(the code makes {want}), journal records {records}")
            if info["launches"].get(name) != per_run or counter.launches != per_run * runs:
                raise AssertionError(f"{label} under {mode}: {name} launched "
                                     f"{info['launches']} a run and {counter.launches} "
                                     f"in all, expected {per_run} a run")
            if mode == "off":
                ref = final
                if not info["pinned"] or calls or records:
                    raise AssertionError(f"{label} under off: graph {info['pinned']}, "
                                         f"{calls} counted, {records} journaled")
            else:
                compare(f"{label}, telemetry {mode} vs off", ref, final,
                        P.State._fields, exact=True)
            if mode == "counters" and not (info["pinned"] and info.get("eager_reason") is None
                                           and calls == want and records == 0):
                raise AssertionError(f"{label} under counters: graph {info['pinned']}, "
                                     f"{calls} sendrecv counted, expected {want}")
            if mode == "events" and not (
                    not info["pinned"]
                    and info.get("eager_reason") == "MPI4JAX_TPU_TELEMETRY=events"
                    and calls == records == want and pending == 0):
                raise AssertionError(
                    f"{label} under events: graph {info['pinned']} "
                    f"({info.get('eager_reason')}), {calls} counted, {records} journaled, "
                    f"{pending} begins unpaired, expected {want}")
            rows[mode] = {"steps": n, "wall": wall, "steps_per_s": n / wall,
                          "graph": info["pinned"], "eager_reason": info.get("eager_reason"),
                          "runs": runs, "launches_per_run": info["launches"].get(name, 0),
                          "launches": counter.launches, "sendrecv_counted": calls,
                          "sendrecv_journaled": records, "bit_for_bit_with_off": True}
            del final
        out[label] = rows
        del ref
        telemetry.reset()
        torch.cuda.empty_cache()
    return out


def runtime_rank(rank, device, nx, ny, t1, tdir, halo_steps):
    """One of four ranks on a (2,2) grid, all on ``device``: the 0.1-day
    ``wide2`` solve and ``halo_steps`` split-phase steps under each tier
    of ``RUNTIME_INTERLEAVED``, the journals of an events run in
    ``tdir/run<k>-events``; each run's final states against the first
    (``off``) run's bit for bit; ``report()`` in the first events run."""
    from mpi4jax_tpu_torch import telemetry
    from mpi4jax_tpu_torch.kernels import sw_phase as KP
    from mpi4jax_tpu_torch.kernels import sw_wide as KW
    from mpi4jax_tpu_torch.models import shallow_water as P
    from mpi4jax_tpu_torch.ops import _staging
    from mpi4jax_tpu_torch.telemetry import journal

    import io

    dev = torch.device(device)
    cfg = P.Config(nx=nx, ny=ny, nproc_y=2, nproc_x=2)
    ref, runs, text = None, [], None
    for k, mode in enumerate(RUNTIME_INTERLEAVED):
        telemetry.reset()
        telemetry.set_telemetry_mode(mode)
        d = os.path.join(tdir, f"run{k}-{mode}")
        if mode == "events":
            os.environ["MPI4JAX_TPU_TELEMETRY_DIR"] = d
        try:
            info = {}
            KW.counter.launches = KP.counter.launches = 0
            wall, n, final = P.solve_fused(cfg, t1, device=dev, fast="auto",
                                           return_state=True, info=info)
            wide_calls = _sendrecv(telemetry.snapshot())[0]
            _, comm = P.make_mesh_and_comm(cfg, device=dev)
            s = P.initial_state(cfg, rank=rank, device=dev)
            first, multi = P.make_stepper(cfg, comm, fast="pallas_halo")
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ex0, t0 = _staging.stats.seconds, time.perf_counter()
            halo = multi(first(s), halo_steps - 1)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            halo_wall = time.perf_counter() - t0
            halo_ex = _staging.stats.seconds - ex0
            journal.flush()
            snap = telemetry.snapshot(include_events=True)
            pending = _pending_journal()
            if mode == "events" and text is None:
                text = telemetry.report(file=io.StringIO())
        finally:
            telemetry.set_telemetry_mode(None)
            os.environ.pop("MPI4JAX_TPU_TELEMETRY_DIR", None)
        fields = tuple(final) + tuple(halo)
        if ref is None:
            ref = fields
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(ref, fields))
        calls, records = _sendrecv(snap)
        runs.append({"mode": mode, "steps": n, "wall": wall, "steps_per_s": n / wall,
                     "runs": info["runs"], "exchange_s": info["exchange_s"],
                     "halo_wall": halo_wall, "halo_exchange_s": halo_ex,
                     "halo_steps_per_s": halo_steps / halo_wall,
                     "wide_launches": KW.counter.launches,
                     "phase_launches": KP.counter.launches,
                     "sendrecv_counted": calls, "sendrecv_journaled": records,
                     "halo_sendrecv_counted": calls - wide_calls,
                     "pending": pending, "bit_for_bit_with_off": same,
                     "finite": all(bool(torch.isfinite(f).all()) for f in fields),
                     "dir": d if mode == "events" else None})
        del final, halo
    return {"runs": runs, "report": text if rank == 0 else None}


def four_rank_runtime(launch, device, t1, tdir, nx=3600, ny=1800):
    """Four gloo ranks on the card: ``runtime_rank`` on each, then each
    events run's journals merged by the port's CLI (the Perfetto JSON
    loaded) and checked: no begin unpaired, one record a ``sendrecv`` call
    and rank, a skew table over four ranks."""
    from mpi4jax_tpu_torch.telemetry import merge

    t0 = time.perf_counter()
    ranks = launch.run(runtime_rank, 4, backend="gloo", device=device, timeout=600,
                       args=(device, nx, ny, t1, tdir, RUNTIME_HALO_STEPS))
    print(f"four ranks under the telemetry tiers: {time.perf_counter() - t0:.1f} s "
          "with start-up")
    for r, res in enumerate(ranks):
        for run in res["runs"]:
            if not (run["bit_for_bit_with_off"] and run["finite"]):
                raise AssertionError(f"rank {r}, {run['mode']}: final state not bit for "
                                     "bit with off's")
            # one Euler launch, then a pair launch each two steps
            per_run = 1 + -(-(run["steps"] - 1) // 2)
            if (run["wide_launches"] != per_run * run["runs"]
                    or run["phase_launches"] != 2 * RUNTIME_HALO_STEPS):
                raise AssertionError(f"rank {r}, {run['mode']}: {run['wide_launches']} "
                                     f"sw_wide and {run['phase_launches']} sw_phase launches")
            want = 0 if run["mode"] == "off" else SENDRECV_A_STEP[4] * RUNTIME_HALO_STEPS
            if run["halo_sendrecv_counted"] != want:
                raise AssertionError(f"rank {r}, {run['mode']}: the split-phase steps "
                                     f"counted {run['halo_sendrecv_counted']} sendrecv, "
                                     f"the code makes {want}")
            if run["mode"] == "events" and (run["pending"]
                                            or run["sendrecv_journaled"] != run["sendrecv_counted"]):
                raise AssertionError(f"rank {r}, events: {run['pending']} begins unpaired, "
                                     f"{run['sendrecv_journaled']} records for "
                                     f"{run['sendrecv_counted']} calls")
    merged = {}
    for k, run0 in enumerate(ranks[0]["runs"]):
        if run0["dir"] is None:
            continue
        d = run0["dir"]
        perfetto = os.path.join(d, "trace.json")
        cli = subprocess.run([sys.executable, "-m", "mpi4jax_tpu_torch.telemetry", "merge",
                              d, "--perfetto", perfetto], capture_output=True, text=True)
        if cli.returncode != 0:
            raise AssertionError(f"merge CLI on {d} failed: {cli.stderr[-2000:]}")
        with open(perfetto) as f:
            trace = json.load(f)
        recs = merge.merge_dir(d)
        per_rank = {}
        for rec in recs:
            if rec["type"] == "op" and rec["op"] == "sendrecv":
                per_rank[rec["rank"]] = per_rank.get(rec["rank"], 0) + 1
        want = {r: res["runs"][k]["sendrecv_counted"] for r, res in enumerate(ranks)}
        table = merge.skew_table(recs)
        print(f"  run {k} (events), merged: {cli.stdout.splitlines()[0]}; "
              f"{len(trace['traceEvents'])} trace events; sendrecv records by rank "
              f"{per_rank} (counted {want})")
        if per_rank != want or sorted(table["per_rank"]) != [0, 1, 2, 3]:
            raise AssertionError(f"run {k}: merged sendrecv records {per_rank}, counted "
                                 f"{want}, skew ranks {sorted(table['per_rank'])}")
        merged[f"run{k}"] = {"records": len(recs), "trace_events": len(trace["traceEvents"]),
                             "sendrecv_by_rank": per_rank,
                             "max_skew_s": table["per_op"]["sendrecv"]["max_skew"],
                             "last_arrivals": {r: v["last_arrivals"]
                                               for r, v in table["per_rank"].items()}}
    print("rank 0's report() in the first events run:")
    print(ranks[0]["report"])
    r0 = [{k: v for k, v in run.items() if k != "dir"} for run in ranks[0]["runs"]]
    for run in r0:
        print(f"  rank 0, {run['mode']}: wide2 {run['steps_per_s']:.2f} steps/s "
              f"({run['exchange_s']:.4f} s of {run['wall']:.4f} in exchanges), "
              f"split-phase {run['halo_steps_per_s']:.2f} steps/s "
              f"({run['halo_exchange_s']:.4f} s of {run['halo_wall']:.4f})")
    return {"rank0": r0, "merged": merged}


def runtime_drills(device, tdir, nx=3600, ny=1800):
    """The four drills of ``models/runtime_drill.py`` at 3600x1800 on
    (2,2), each its own launch, all started at once; each checked."""
    from concurrent.futures import ThreadPoolExecutor

    from mpi4jax_tpu_torch.models import runtime_drill
    from mpi4jax_tpu_torch.telemetry import merge

    def one(name):
        return name, runtime_drill.run_drill(
            name, device=device, nx=nx, ny=ny, timeout=DRILL_TIMEOUT_S,
            delay=DRILL_DELAY_S, hang=DRILL_HANG_S, limit=180,
            workdir=os.path.join(tdir, f"drill-{name}"))

    with ThreadPoolExecutor(4) as pool:
        res = dict(pool.map(one, runtime_drill.DRILLS))
    out = {}
    d = res["delay"]
    table = merge.skew_table(merge.merge_dir(d["dir"]))
    arrivals = {r: v["last_arrivals"] for r, v in table["per_rank"].items()}
    late = max(arrivals, key=arrivals.get)
    print(f"drill delay (rank 2, {DRILL_DELAY_S} s at its 10th sendrecv and after): exit "
          f"{d['exit']}, {d['seconds']:.1f} s; last arrivals by rank {arrivals}; max skew "
          f"{table['per_op']['sendrecv']['max_skew']:.4f} s")
    print(merge.render_skew(table))
    if d["exit"] != [0, 0, 0, 0] or late != 2:
        raise AssertionError(f"delay drill: exits {d['exit']}, late rank {late}")
    out["delay"] = {"exit": d["exit"], "seconds": d["seconds"], "last_arrivals": arrivals,
                    "max_skew_s": table["per_op"]["sendrecv"]["max_skew"]}

    w = res["watchdog"]
    lines = {}
    for r in (0, 1, 3):
        m = re.search(rf"r{r} \| WATCHDOG \| in-flight: MPI_Sendrecv \(call [0-9a-f]{{8}}, "
                      r"axes=.*elapsed (\d+\.\d+)s\)", w["stderr"][r])
        fatal = re.search(rf"r{r} \| FATAL: collective watchdog: MPI_Sendrecv exceeded "
                          rf"{DRILL_TIMEOUT_S:g}s \(call [0-9a-f]{{8}}, axes=[^)]*\)\)",
                          w["stderr"][r])
        if w["exit"][r] == 0 or not m or not fatal:
            raise AssertionError(f"watchdog drill, rank {r}: exit {w['exit'][r]}, "
                                 f"stderr {w['stderr'][r][-1500:]}")
        lines[r] = [m.group(0), fatal.group(0)]
        print(f"  {m.group(0)}\n  {fatal.group(0)}")
    print(f"drill watchdog (rank 2 delayed {DRILL_HANG_S} s, watchdog {DRILL_TIMEOUT_S} s): "
          f"exit {w['exit']}, {w['seconds']:.1f} s")
    if w["exit"][2] == 0:
        raise AssertionError("watchdog drill: the delayed rank finished")
    out["watchdog"] = {"exit": w["exit"], "seconds": w["seconds"], "lines": lines}

    c = res["corrupt"]
    guard = re.search(r"r0 \| FATAL: MPI_Sendrecv: non-finite input detected "
                      r"\(MPI4JAX_TPU_CHECK_NUMERICS, call [0-9a-f]{8}\)", c["stderr"][0])
    print(f"drill corrupt (rank 0's sendrecv inputs NaN, numeric guards): exit "
          f"{c['exit']}, {c['seconds']:.1f} s: {guard.group(0) if guard else None}")
    if not guard or c["exit"][0] in (0, 13):
        raise AssertionError(f"corrupt drill: exit {c['exit']}, {c['stderr'][0][-1500:]}")
    out["corrupt"] = {"exit": c["exit"], "seconds": c["seconds"], "line": guard.group(0)}

    x = res["die"]
    print(f"drill die (rank 1 in its 5th sendrecv, watchdog {DRILL_TIMEOUT_S} s): exit "
          f"{x['exit']}, {x['seconds']:.1f} s")
    if x["exit"][1] != 13 or "die injected in MPI_Sendrecv" not in x["stderr"][1] \
            or any(code in (0, None) for code in x["exit"]):
        raise AssertionError(f"die drill: exit {x['exit']}")
    out["die"] = {"exit": x["exit"], "seconds": x["seconds"]}
    return out


def runtime_call_cost(dev):
    """Host us a call of the generic (8, 256) step on one CUDA rank, eager
    ``spmd``, under off, counters, events, watchdog, numeric guards and off
    again (in this order, one process), and a pinned one-step graph under
    off and counters."""
    import mpi4jax_tpu_torch as tpx
    from mpi4jax_tpu_torch import resilience, telemetry

    comm = tpx.Comm("x", mesh=tpx.make_world_mesh((1,), ("x",), device=dev))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(GENERIC_SHAPE).astype(np.float32)).to(dev)
    eager = tpx.spmd(generic_step, comm=comm)
    tiers = (("off", {}), ("counters", {"telemetry": "counters"}),
             ("events", {"telemetry": "events"}), ("watchdog", {"watchdog": 10.0}),
             ("numerics", {"numerics": True}), ("off_again", {}))
    us = {}
    for label, knobs in tiers:
        telemetry.set_telemetry_mode(knobs.get("telemetry"))
        resilience.set_watchdog_timeout(knobs.get("watchdog"))
        resilience.set_check_numerics(knobs.get("numerics", False))
        try:
            us[label] = host_us(eager, x, GENERIC_CALLS)
        finally:
            telemetry.set_telemetry_mode(None)
            resilience.reset_overrides()
            telemetry.reset()
    pinned = {}
    for mode in ("off", "counters"):
        telemetry.set_telemetry_mode(mode)
        try:
            one = tpx.compile(generic_step, x, comm=comm)
            pinned[mode] = host_us(one, x, GENERIC_CALLS)
            if not one.graph:
                raise AssertionError(f"the pin under {mode} is not a graph")
        finally:
            telemetry.set_telemetry_mode(None)
            telemetry.reset()
    print("  host us a call of the generic (8, 256) step, eager spmd: "
          + json.dumps(us) + "; pinned one-step graph: " + json.dumps(pinned)
          + "; phase 10 before the runtime services (H100 80GB HBM3, 700 W): "
          + json.dumps(BEFORE_SERVICES_HOST_US))
    return {"eager_spmd": us, "pinned": pinned,
            "before_services": BEFORE_SERVICES_HOST_US}


def runtime_phase(P, dev, launch):
    """Phase 11 (see the module docstring); returns its summary, printed
    as one JSON line."""
    from concurrent.futures import ThreadPoolExecutor

    from mpi4jax_tpu_torch import native

    import tempfile

    t0 = time.perf_counter()
    t1 = 0.1 * P.DAY_IN_SECONDS
    parts = {}
    out = {"host_library": native.build(verbose=False)}
    out["one_gpu"] = runtime_solves(P, dev, t1)
    _part(parts, "one_gpu_solves", t0, 11)
    out["call_cost_us"] = runtime_call_cost(dev)
    _part(parts, "call_cost", t0, 11)
    # the journals and the drills' logs, removed at the end; the drills
    # run beside the four ranks' tiers
    with tempfile.TemporaryDirectory(prefix="mpx-runtime-") as tdir, \
            ThreadPoolExecutor(1) as pool:
        drills = pool.submit(runtime_drills, "cuda:0", tdir)
        out["four_ranks"] = four_rank_runtime(
            launch, "cuda:0", RUNTIME_FOUR_RANK_DAYS * P.DAY_IN_SECONDS, tdir)
        _part(parts, "four_ranks", t0, 11)
        out["drills"] = drills.result()
        _part(parts, "drills", t0, 11)
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = parts
    print(f"phase 11 (runtime services): {out['seconds']:.1f} s; by part "
          + json.dumps({k: round(v, 1) for k, v in parts.items()}))
    return out


def runtime_main():
    """``python3 chip_smoke.py --runtime``: builds the stencil sources and
    the host library and runs phase 11 alone; one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    from mpi4jax_tpu_torch import native
    from mpi4jax_tpu_torch.kernels import _build
    from mpi4jax_tpu_torch.kernels import sw_phase as KP
    from mpi4jax_tpu_torch.kernels import sw_steps as K
    from mpi4jax_tpu_torch.kernels import sw_wide as KW
    from mpi4jax_tpu_torch.models import shallow_water as P
    from mpi4jax_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    _build.build_many([K.spec(), KP.spec(), KW.spec()])
    native.build(verbose=False)
    print(f"built the stencil sources and the host library in "
          f"{time.perf_counter() - t0:.1f} s")
    out = runtime_phase(P, torch.device("cuda"), launch)
    print(smi)
    print(json.dumps({"runtime": out}))
    return 0


# phase 12: the health plane.  (a) and (b) run in this process, the
# flags set in its environment for each run; (c) and the drills on four
# gloo ranks
HEALTH_RUNS = ("off", "on", "on", "off")
HEALTH_STEPS = 20
HEALTH_DELAY_SPEC = "delay:rank=2:op=sendrecv:after=300:secs=0.05"
HEALTH_DRILLS = ("health_hang", "health_die")


def _set_health(on):
    if on:
        os.environ["MPI4JAX_TPU_HEALTH"] = "on"
    else:
        os.environ.pop("MPI4JAX_TPU_HEALTH", None)


def health_solves(P, dev, t1):
    """One GPU, 3600x1800, 0.1 day, the split-phase solve
    (``fast="pallas_halo"``, ``pinned=True``): (a) under ``counters`` with
    the health plane off, on, on, off in this process: each final state bit
    for bit with the first ``off``'s, 882 ``sw_phase`` launches a run, the
    pin still a graph, the ring's ``total`` the run's counted ``sendrecv``
    calls and its ``dropped`` that less its capacity; (b) under ``events``,
    where the pin runs eagerly, off and on: every call a begin and a
    record in the ring, begins and records equal within its window."""
    from mpi4jax_tpu_torch import telemetry
    from mpi4jax_tpu_torch.kernels import _build
    from mpi4jax_tpu_torch.telemetry import health
    from mpi4jax_tpu_torch.utils.config import DEFAULT_FLIGHT_RING as RING

    cfg = P.Config(nx=3600, ny=1800)
    counter = _build.counter_for("sw_phase")
    ref, rows, prom = None, {}, None
    for k, (mode, on) in enumerate([("counters", h == "on") for h in HEALTH_RUNS]
                                   + [("events", False), ("events", True)]):
        label = f"{mode},{'on' if on else 'off'}#{k}"
        telemetry.reset()
        telemetry.set_telemetry_mode(mode)
        _set_health(on)
        try:
            info = {}
            counter.launches = 0
            wall, n, final = P.solve_fused(cfg, t1, device=dev, fast="pallas_halo",
                                           pinned=True, return_state=True, info=info)
            torch.cuda.synchronize()
            calls = _sendrecv(telemetry.snapshot())[0]
            ring = health.flight_snapshot()
            dropped = telemetry.snapshot().get("dropped")
            if mode == "counters" and on:
                prom = health.prometheus_text()
        finally:
            telemetry.set_telemetry_mode(None)
            _set_health(False)
        runs = info["runs"]
        window = ring["records"]
        begins = sum(1 for r in window if r.get("kind") == "begin")
        ops = sum(1 for r in window if r.get("type") == "op")
        dispatches = sum(1 for r in window if r.get("kind") == "dispatch")
        same = ref is None or all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                                  for a, b in zip(ref, final))
        print(f"split-phase, {mode}, health {'on' if on else 'off'}: {n / wall:.2f} "
              f"steps/s, graph {info['pinned']} "
              f"({info.get('eager_reason') or 'no per-op hook'}), "
              f"{info['launches'].get('sw_phase', 0)} sw_phase launches a run, "
              f"{counter.launches} over {runs} runs; sendrecv counted {calls}; ring "
              f"total {ring['total']}, dropped {ring['dropped']}, window "
              f"{len(window)} ({dispatches} dispatch, {begins} begins, {ops} records); "
              f"{'the reference' if ref is None else f'bit for bit with it: {same}'}")
        if info["launches"].get("sw_phase") != 882 or counter.launches != 882 * runs:
            raise AssertionError(f"{label}: sw_phase launched {info['launches']} a run "
                                 f"and {counter.launches} in all")
        if not same:
            raise AssertionError(f"{label}: the final state differs from the "
                                 "first off run's")
        if ref is None:
            ref = final
        if mode == "counters" and not (info["pinned"] and info.get("eager_reason") is None):
            raise AssertionError(f"{label}: the pin is not a graph ({info})")
        if mode == "events" and info["pinned"]:
            raise AssertionError(f"{label}: the pin kept its graph under events")
        # a counted call spills its dispatch record; under events also its
        # begin and its journal record
        want_total = (0 if not on else calls if mode == "counters" else 3 * calls)
        if ring["total"] != want_total or ring["dropped"] != max(0, want_total - RING):
            raise AssertionError(f"{label}: ring total {ring['total']}, dropped "
                                 f"{ring['dropped']}, expected {want_total}")
        if on and mode == "counters" and dispatches != min(RING, calls):
            raise AssertionError(f"{label}: {dispatches} dispatch records in the window")
        if on and mode == "events" and not (
                begins == ops and abs(dispatches - begins) <= 1
                and dispatches + begins + ops == len(window)):
            raise AssertionError(f"{label}: {dispatches} dispatches, {begins} begins, "
                                 f"{ops} records in the window")
        if not on and (ring["capacity"] or dropped is not None):
            raise AssertionError(f"{label}: a ring ({ring['capacity']}) or a dropped "
                                 f"key ({dropped}) with health off")
        rows[label] = {"mode": mode, "health": on, "steps": n, "wall": wall,
                       "steps_per_s": n / wall, "graph": info["pinned"],
                       "eager_reason": info.get("eager_reason"), "runs": runs,
                       "launches_per_run": info["launches"].get("sw_phase", 0),
                       "launches": counter.launches, "sendrecv_counted": calls,
                       "ring_total": ring["total"], "ring_dropped": ring["dropped"],
                       "window_begins": begins, "window_records": ops,
                       "window_dispatches": dispatches, "bit_for_bit": same}
        del final
        telemetry.reset()
        torch.cuda.empty_cache()
    del ref
    return rows, prom


def health_rank(rank, device, nx, ny, tdir, steps, specs):
    """One of four ranks on a (2,2) grid: for each fault spec of ``specs``
    ('' for none), ``steps`` split-phase steps under ``events`` with the
    health plane on, ``on_boundary`` after every step with the grid's comm,
    the Prometheus file into ``tdir/<k>``; each boundary's findings and
    wall."""
    from mpi4jax_tpu_torch import resilience, telemetry
    from mpi4jax_tpu_torch.kernels import sw_phase as KP
    from mpi4jax_tpu_torch.models import shallow_water as P
    from mpi4jax_tpu_torch.telemetry import health

    import contextlib
    import io

    dev = torch.device(device)
    cfg = P.Config(nx=nx, ny=ny, nproc_y=2, nproc_x=2)
    _, comm = P.make_mesh_and_comm(cfg, device=dev)
    first, multi = P.make_stepper(cfg, comm, fast="pallas_halo")
    s0 = P.initial_state(cfg, rank=rank, device=dev)
    multi(first(s0), 1)  # warm-up, every service off
    if dev.type == "cuda":
        torch.cuda.synchronize()
    runs = []
    os.environ["MPI4JAX_TPU_HEALTH"] = "on"
    os.environ["MPI4JAX_TPU_HEALTH_PROM"] = "1"
    for k, spec in enumerate(specs):
        d = os.path.join(tdir, f"run{k}")
        os.environ["MPI4JAX_TPU_TELEMETRY_DIR"] = d
        telemetry.reset()
        resilience.reset_fault_state()
        resilience.set_fault_spec(spec or None)
        telemetry.set_telemetry_mode("events")
        KP.counter.launches = 0
        findings, exchange_ms = [], []
        t0 = time.perf_counter()
        s = s0
        # the fault probe's line per injection, kept out of the call's output
        lines = io.StringIO()
        with contextlib.redirect_stderr(lines):
            for step in range(steps):
                s = first(s) if step == 0 else multi(s, 1)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                b0 = time.perf_counter()
                findings.append(health.on_boundary(step, comm=comm))
                exchange_ms.append((time.perf_counter() - b0) * 1e3)
        wall = time.perf_counter() - t0
        telemetry.set_telemetry_mode(None)
        resilience.set_fault_spec(None)
        snap = telemetry.snapshot()
        runs.append({"spec": spec, "findings": findings, "exchange_ms": exchange_ms,
                     "wall": wall, "exchanges": health._detector.exchanges,
                     "launches": KP.counter.launches,
                     "sendrecv_calls": _sendrecv(snap)[0],
                     "meters": {k: v for k, v in snap["meters"].items()
                                if k.startswith("health.") or k.startswith("faults.")},
                     "prom": os.path.exists(os.path.join(
                         d, f"{health.PROM_FILE_PREFIX}{rank}.prom")),
                     "finite": all(bool(torch.isfinite(f).all()) for f in s),
                     "fault_lines": lines.getvalue().splitlines()[:1]})
    for k in ("MPI4JAX_TPU_HEALTH", "MPI4JAX_TPU_HEALTH_PROM",
              "MPI4JAX_TPU_TELEMETRY_DIR"):
        os.environ.pop(k, None)
    return runs


def _verdicts(boundary_findings):
    return [[(f["rank"], f["key"], f["persistent"]) for f in (b or ())
             if f["kind"] == "slow_rank"] for b in boundary_findings]


def four_rank_health(launch, device, tdir, nx=3600, ny=1800):
    """(c): ``health_rank`` on four gloo ranks, without a fault and then
    under ``HEALTH_DELAY_SPEC``: ``HEALTH_STEPS`` exchanges a run, the same
    cross-rank verdicts on every rank, a Prometheus file a rank, 40
    ``sw_phase`` launches a rank and run; each exchange's ms on rank 0 and
    each rank's findings printed."""
    t0 = time.perf_counter()
    ranks = launch.run(health_rank, 4, backend="gloo", device=device, timeout=300,
                       args=(device, nx, ny, tdir, HEALTH_STEPS, ("", HEALTH_DELAY_SPEC)))
    print(f"four ranks, health on, {HEALTH_STEPS} split-phase steps a run: "
          f"{time.perf_counter() - t0:.1f} s with start-up")
    out = []
    for k, run0 in enumerate(ranks[0]):
        verdicts = _verdicts(run0["findings"])
        for r, res in enumerate(ranks):
            run = res[k]
            if _verdicts(run["findings"]) != verdicts:
                raise AssertionError(f"run {k}: rank {r}'s verdicts differ from rank 0's")
            if run["exchanges"] != HEALTH_STEPS or not run["prom"] or not run["finite"]:
                raise AssertionError(f"run {k}, rank {r}: {run['exchanges']} exchanges, "
                                     f"prom {run['prom']}, finite {run['finite']}")
            # kernels launch on the card only (the plain versions run on the
            # CPU, where this phase is rehearsed)
            want = 2 * HEALTH_STEPS if device.startswith("cuda") else 0
            if run["launches"] != want or \
                    run["sendrecv_calls"] != SENDRECV_A_STEP[4] * HEALTH_STEPS:
                raise AssertionError(f"run {k}, rank {r}: {run['launches']} sw_phase, "
                                     f"{run['sendrecv_calls']} sendrecv")
        named = sorted({v[0] for b in verdicts for v in b})
        persistent = sorted({v[0] for b in verdicts for v in b if v[2]})
        ms = run0["exchange_ms"]
        print(f"  run {k} ({run0['spec'] or 'no fault'}): wall {run0['wall']:.3f} s; "
              f"exchange ms on rank 0 min {min(ms):.3f} median "
              f"{sorted(ms)[len(ms) // 2]:.3f} max {max(ms):.3f}; slow ranks named "
              f"{named}, persistent {persistent}; delays injected "
              f"{[res[k]['meters'].get('faults.injected', 0) for res in ranks]} "
              f"{[ln for res in ranks for ln in res[k]['fault_lines']]}")
        for r, res in enumerate(ranks):
            local = [[(f["key"].split("|")[0], round(f["ratio"], 2))
                      for f in (b or ()) if f["kind"] == "degraded"]
                     for b in res[k]["findings"]]
            print(f"    rank {r}: degraded at boundaries "
                  f"{[i for i, b in enumerate(local) if b]} "
                  f"{[b for b in local if b][:3]}; meters {res[k]['meters']}")
        out.append({"spec": run0["spec"], "wall": run0["wall"],
                    "exchange_ms_rank0": ms, "slow_ranks_named": named,
                    "persistent": persistent, "verdicts_by_boundary": verdicts,
                    "degraded_boundaries_by_rank": {
                        r: [i for i, b in enumerate(res[k]["findings"])
                            if any(f["kind"] == "degraded" for f in (b or ()))]
                        for r, res in enumerate(ranks)},
                    "launches_rank0": run0["launches"]})
    return out


def start_health_drills(device, tdir, nx=3600, ny=1800):
    """(d): the health-armed drills, started together in threads of their
    own; ``{name: future}``, each future's result ``run_drill``'s."""
    from concurrent.futures import ThreadPoolExecutor

    from mpi4jax_tpu_torch.models import runtime_drill

    pool = ThreadPoolExecutor(len(HEALTH_DRILLS))
    futures = {name: pool.submit(
        runtime_drill.run_drill, name, device=device, nx=nx, ny=ny,
        timeout=DRILL_TIMEOUT_S, limit=180, workdir=os.path.join(tdir, f"drill-{name}"))
        for name in HEALTH_DRILLS}
    pool.shutdown(wait=False)
    return futures


def check_health_drills(res):
    """(d)'s checks on ``run_drill``'s results: ``health_hang`` (four
    bundles, the command names rank 2, the hung rank killed once the others
    ended) and ``health_die`` (rank 1's bundle, the command names rank
    1)."""
    out = {}
    for name, rank, reason in (
            ("health_hang", 2, "fault: hang injected in MPI_Sendrecv on rank 2"),
            ("health_die", 1, "fatal_fault: die injected in MPI_Sendrecv on rank 1")):
        d = res[name]
        bundles = sorted(f for f in os.listdir(d["dir"]) if f.startswith("postmortem-p"))
        with open(os.path.join(d["dir"], f"postmortem-p{rank}.json")) as f:
            reasons = json.load(f)["reasons"]
        cli = subprocess.run([sys.executable, "-m", "mpi4jax_tpu_torch.telemetry",
                              "postmortem", d["dir"]], capture_output=True, text=True)
        suspects = [ln for ln in cli.stdout.splitlines()
                    if ln.startswith("suspected straggler")]
        print(f"drill {name}: exit {d['exit']}, {d['seconds']:.1f} s, bundles {bundles}, "
              f"rank {rank}'s reasons {reasons}")
        for ln in suspects:
            print(f"  {ln}")
        want_bundles = 4 if name == "health_hang" else 1
        if (cli.returncode != 0 or len(bundles) != want_bundles or reasons != [reason]
                or not suspects or not suspects[0].startswith(
                    f"suspected straggler: rank {rank} — fault incident")):
            raise AssertionError(f"drill {name}: rc {cli.returncode}, bundles {bundles}, "
                                 f"reasons {reasons}, {cli.stdout[-1500:]} "
                                 f"{cli.stderr[-1500:]}")
        if name == "health_hang" and d["exit"][2] != -9:
            raise AssertionError(f"drill {name}: the hung rank exited {d['exit'][2]}")
        out[name] = {"exit": d["exit"], "seconds": d["seconds"], "bundles": bundles,
                     "reasons": reasons, "suspects": suspects}
    return out


def _trace_events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def health_profiles(P, dev, tdir):
    """(e): ``profile_ops`` around one megastep call of
    ``solve_fused(fast="auto", unroll=20)``'s pin (20 ``sw_steps`` kernels
    in the trace, ``fenced_arrays`` > 0), and around one eager split-phase
    step (its ``mpi4jax_tpu.sendrecv`` ranges and 2 ``sw_phase`` kernels)."""
    import mpi4jax_tpu_torch as tpx
    from mpi4jax_tpu_torch.aot import pinning
    from mpi4jax_tpu_torch.kernels import _build

    out = {}
    cfg = P.Config(nx=3600, ny=1800)
    _, comm = P.make_mesh_and_comm(cfg, device=dev)
    step, chunk, size = P.select_steps("auto", cfg)

    def one(s):
        return P._run_steps(s, 1, cfg, comm, step, chunk, size)

    s0 = P.initial_state(cfg, device=dev)
    pp = pinning.compile(one, s0, comm=comm, unroll=20)
    s1 = pp(s0)
    torch.cuda.synchronize()
    steps_counter = _build.counter_for("sw_steps")
    steps_counter.launches = 0
    with tpx.profile_ops(os.path.join(tdir, "megastep")) as prof:
        s2 = pp(s1)
    events = _trace_events(prof.trace_file)
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "sw_steps" in e.get("name", "")]
    print(f"profile_ops, one unroll=20 megastep call (graph {pp.graph}): "
          f"{len(kernels)} sw_steps kernels in the trace, {steps_counter.launches} "
          f"launches counted, fenced_arrays {prof.fenced_arrays}, "
          f"{len(events)} trace events")
    if len(kernels) != 20 or steps_counter.launches != 20 or not prof.fenced_arrays:
        raise AssertionError(f"megastep profile: {len(kernels)} kernels, "
                             f"{steps_counter.launches} launches, fenced "
                             f"{prof.fenced_arrays}")
    out["megastep"] = {"graph": pp.graph, "sw_steps_kernels": len(kernels),
                       "launches": steps_counter.launches,
                       "kernel_us": sum(e.get("dur", 0) for e in kernels),
                       "fenced_arrays": prof.fenced_arrays,
                       "trace_events": len(events)}
    del pp, s0, s1, s2
    torch.cuda.empty_cache()

    first, multi = P.make_stepper(cfg, comm, fast="pallas_halo")
    s = first(P.initial_state(cfg, device=dev))
    multi(s, 1)
    torch.cuda.synchronize()
    phase_counter = _build.counter_for("sw_phase")
    phase_counter.launches = 0
    with tpx.profile_ops(os.path.join(tdir, "eager")) as prof:
        s = multi(s, 1)
    events = _trace_events(prof.trace_file)
    # the host's ranges (the profiler also mirrors each onto the device's
    # timeline as a gpu_user_annotation)
    ranges = [e for e in events if e.get("name") == "mpi4jax_tpu.sendrecv"
              and e.get("cat") != "gpu_user_annotation"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "sw_phase" in e.get("name", "")]
    print(f"profile_ops, one eager split-phase step: {len(ranges)} "
          f"mpi4jax_tpu.sendrecv ranges, {len(kernels)} sw_phase kernels, "
          f"{phase_counter.launches} launches counted, fenced_arrays "
          f"{prof.fenced_arrays}")
    if len(ranges) != SENDRECV_A_STEP[1] or len(kernels) != 2 or phase_counter.launches != 2:
        raise AssertionError(f"eager profile: {len(ranges)} ranges, {len(kernels)} "
                             f"kernels, {phase_counter.launches} launches")
    out["eager_step"] = {"sendrecv_ranges": len(ranges), "sw_phase_kernels": len(kernels),
                         "launches": phase_counter.launches,
                         "range_us": sum(e.get("dur", 0) for e in ranges),
                         "fenced_arrays": prof.fenced_arrays}
    del s
    torch.cuda.empty_cache()
    return out


def profile_rank(rank, device, tdir):
    """(e) in a process of its own: in the smoke run's long-lived process
    (phases 1-11 before it) the trace of one megastep replay held only 10
    and then 8 of its 20 kernels, in two full runs; in the shorter
    processes of three other calls all 18 captures held all 20."""
    from mpi4jax_tpu_torch.models import shallow_water as P

    return health_profiles(P, torch.device(device), tdir)


def health_phase(P, dev, launch):
    """Phase 12 (see the module docstring); returns its summary, printed as
    one JSON line."""
    import tempfile

    import mpi4jax_tpu_torch as tpx
    from mpi4jax_tpu_torch import native

    t0 = time.perf_counter()
    t1 = 0.1 * P.DAY_IN_SECONDS
    native.build(verbose=False)
    from concurrent.futures import ThreadPoolExecutor

    out, parts = {}, {}
    out["one_gpu"], prom = health_solves(P, dev, t1)
    parts["one_gpu"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="mpx-health-") as tdir:
        # the drills' ranks and (e)'s process run beside (c): they check
        # counts, bundles and traces, not times
        drills = start_health_drills("cuda:0", tdir)
        pool = ThreadPoolExecutor(1)
        profiles = pool.submit(launch.run, profile_rank, 1, backend="gloo",
                               device="cuda:0", timeout=300, args=("cuda:0", tdir))
        pool.shutdown(wait=False)
        try:
            out["four_ranks"] = four_rank_health(launch, "cuda:0", tdir)
            parts["four_ranks"] = time.perf_counter() - t0 - sum(parts.values())
        finally:
            # every drill's and (e)'s process has ended before the directory
            # goes
            res = {name: f.result() for name, f in drills.items()}
            out["profiles"] = profiles.result()[0]
        parts["drills_and_profiles_after"] = (time.perf_counter() - t0
                                              - sum(parts.values()))
        out["drills"] = check_health_drills(res)
    print("prometheus_text() of the first counters run with health on:")
    print(prom, end="")
    out["cache_stats"] = tpx.cache_stats()
    print("cache_stats(): " + json.dumps(out["cache_stats"]))
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = parts
    print(f"phase 12 (health plane): {out['seconds']:.1f} s; by part "
          + json.dumps({k: round(v, 1) for k, v in parts.items()}))
    return out


def health_main():
    """``python3 chip_smoke.py --health``: builds the stencil sources and
    the host library and runs phase 12 alone; one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    from mpi4jax_tpu_torch import native
    from mpi4jax_tpu_torch.kernels import _build
    from mpi4jax_tpu_torch.kernels import sw_phase as KP
    from mpi4jax_tpu_torch.kernels import sw_steps as K
    from mpi4jax_tpu_torch.kernels import sw_wide as KW
    from mpi4jax_tpu_torch.models import shallow_water as P
    from mpi4jax_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    _build.build_many([K.spec(), KP.spec(), KW.spec()])
    native.build(verbose=False)
    print(f"built the stencil sources and the host library in "
          f"{time.perf_counter() - t0:.1f} s")
    out = health_phase(P, torch.device("cuda"), launch)
    print(smi)
    print(json.dumps({"health": out}))
    return 0


def elastic_clean_rank(rank, device, params, start, steps, rdv, port_base,
                       grid=None, ef_state=True, lr=None):
    """Phase 13's reference: the example's loop on a clean world of this
    size (a ``("y", "x")`` grid of shape ``grid``, if given) from a state
    the drill handed a step (``params`` at step ``start``)."""
    from mpi4jax_tpu_torch import Comm, make_world_mesh
    from mpi4jax_tpu_torch.models import elastic_training as ET
    from mpi4jax_tpu_torch.resilience import elastic

    if grid is None:
        mesh = make_world_mesh(device=device)
    else:
        mesh = make_world_mesh(tuple(grid), ("y", "x"), device=device)
    comm = Comm(mesh.axes, mesh=mesh)
    store = elastic.ShardStore(comm, bootstrap={
        "rendezvous": rdv, "host": "localhost", "port_base": port_base,
        "process_id": rank, "num_processes": comm.Get_size()})
    step_fn, losses = ET.make_elastic_step(ET.LR if lr is None else lr,
                                           store=store, ef_state=ef_state)
    # one commit at the end: commits change no bits, and every one of them
    # at 33.6 MB is a device-to-host copy
    state = elastic.run(step_fn, {"params": ET.to_device(params, device)},
                        store, steps=steps, start_step=start,
                        commit_every=max(1, steps - start))
    return {"losses": [(r["step"], r["world"], r["loss"]) for r in losses],
            "params": ET.to_numpy(state["params"])}


class _Calls:
    """An ``ElasticStep`` recording each call's step and epoch, and the pin
    counters' moves over its calls (a revoke resets them in between)."""

    def __init__(self, inner):
        self.inner, self.unroll, self.calls = inner, inner.unroll, []
        self.pins = self.stale = 0

    def __call__(self, state, step, comm):
        from mpi4jax_tpu_torch import aot

        self.calls.append((int(step), comm.epoch))
        before = aot.stats()["aot"]
        try:
            return self.inner(state, step, comm)
        finally:
            after = aot.stats()["aot"]
            self.pins += after["pins"] - before["pins"]
            self.stale += after["stale_raises"] - before["stale_raises"]

    def repin(self):
        self.inner.repin()
        return self


def elastic_body(state, step, comm):
    """Phase 13 (d)'s iteration: ``w = w/2 + mean_ranks(w)/4 + step``
    (capturable: no host synchronisation)."""
    import mpi4jax_tpu_torch as tpx

    total, _ = tpx.allreduce(state["w"], comm=comm)
    return {"w": state["w"] * 0.5 + total * (0.25 / comm.Get_size())
            + step.to(state["w"].dtype)}


def elastic_megastep_rank(rank, device, rdv, port_base, unroll, steps):
    """Phase 13 (d) on four ranks: ``compile_step(elastic_body, unroll)``
    under ``elastic.run``, rank 3 lost (simulated) inside the megastep
    starting at step 4; eager pins (several ranks)."""
    import mpi4jax_tpu_torch as tpx
    from mpi4jax_tpu_torch import aot
    from mpi4jax_tpu_torch.resilience import elastic

    def body(state, step, comm):
        if int(step) == 5 and comm.epoch == 0:
            raise elastic.RankFailure({3}, "simulated loss inside a megastep")
        return elastic_body(state, step, comm)

    mesh = tpx.make_world_mesh(device=device)
    comm = tpx.Comm(mesh.axes[0], mesh=mesh)
    store = elastic.ShardStore(comm, bootstrap={
        "rendezvous": rdv, "host": "localhost", "port_base": port_base,
        "process_id": rank, "num_processes": 4})
    step_fn = _Calls(aot.compile_step(body, unroll=unroll))
    state = {"w": torch.arange(1 << 16, dtype=torch.float32, device=device)}
    try:
        state = elastic.run(step_fn, state, store, steps=steps)
    except elastic.RankFailure as rf:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        return {"declared": str(rf)}
    return {"calls": step_fn.calls, "pins": step_fn.pins,
            "stale_raises": step_fn.stale, "world": store.comm.Get_size(),
            "epoch": elastic.current_epoch(), "graph": step_fn.inner.pinned.graph,
            "w_sha": hashlib.sha256(state["w"].cpu().numpy().tobytes()).hexdigest()}


def elastic_one_rank_graph(rank, dev):
    """Phase 13 (d) on one rank, in a process of its own (``launch.run``
    with one rank), since it advances the epoch and resets the pin
    counters: the pin a CUDA graph, ``advance_epoch()`` between two calls
    raises ``StaleProgramError``, and the re-pin over a comm of the new
    epoch is a graph again; each result against the eager iterations bit
    for bit."""
    import mpi4jax_tpu_torch as tpx
    from mpi4jax_tpu_torch import aot
    from mpi4jax_tpu_torch.resilience import elastic

    dev = torch.device(dev)
    def comm1():
        mesh = tpx.make_world_mesh(device=dev)
        return tpx.Comm(mesh.axes[0], mesh=mesh)

    def eager(state, step, comm, n):
        for i in range(n):
            state = elastic_body(state, torch.tensor(step + i, dtype=torch.int32,
                                                     device=dev), comm)
        return state

    unroll = 4
    comm = comm1()
    es = aot.compile_step(elastic_body, unroll=unroll)
    s0 = {"w": torch.linspace(-1, 1, 1 << 16, device=dev)}
    aot.reset_stats()
    out = es(s0, 0, comm)
    first = {"graph": es.pinned.graph,
             "bitwise": torch.equal(out["w"], eager(s0, 0, comm, unroll)["w"])}
    replays = aot.stats()["aot"]["replays"]
    elastic.advance_epoch(cause="revoke", detail="phase 13 (d)")
    try:
        es(out, unroll, comm)
        stale = None
    except aot.StaleProgramError as e:
        stale = getattr(e, "mpx_code", None)
    es.repin()
    fresh = comm1()
    again = es(out, unroll, fresh)
    second = {"graph": es.pinned.graph,
              "bitwise": torch.equal(again["w"],
                                     eager(out, unroll, fresh, unroll)["w"])}
    replays2 = aot.stats()["aot"]["replays"]
    res = {"first": first, "stale": stale, "second": second,
           "replays": [replays, replays2]}
    if not (first["graph"] and second["graph"] and stale == "MPX129"
            and first["bitwise"] and second["bitwise"] and replays2 > replays):
        raise AssertionError(f"phase 13 (d) one-rank graph pin: {res}")
    return res


def _recovery_line(label, res, ranks):
    for r in ranks:
        out = res["results"][r]
        (rec,) = out["recoveries"]
        first3 = next(x for x in out["losses"] if x["epoch"] == 1)
        print(f"  {label} rank {r}: failed {rec['failed']} at step "
              f"{rec['step']}; detection {rec['detect_s'] * 1e3:.1f} ms, "
              f"agreement {rec['agree_s'] * 1e3:.1f} ms, re-bootstrap "
              f"{rec['rebootstrap_s'] * 1e3:.1f} ms, restore "
              f"{rec['restore_s'] * 1e3:.1f} ms, first step at world 3 "
              f"{first3['seconds'] * 1e3:.1f} ms")


def _check_drill(label, res, lost, lost_exit, steps):
    survivors = [r for r in range(4) if r != lost]
    if not res["ok"] or res["completed"] != survivors:
        raise AssertionError(f"{label}: drill failed: exit {res['exit']}, "
                             f"stderr {[e[-800:] for e in res['stderr']]}")
    if res["exit"][lost] != lost_exit:
        raise AssertionError(f"{label}: rank {lost} exit {res['exit'][lost]}, "
                             f"expected {lost_exit}")
    for r in survivors:
        out = res["results"][r]
        if out["final_world"] != 3 or out["epoch"] != 1:
            raise AssertionError(f"{label}: rank {r} ended at world "
                                 f"{out['final_world']}, epoch {out['epoch']}")
        if out["losses"][-1]["step"] != steps - 1:
            raise AssertionError(f"{label}: rank {r} did not finish the budget")
        if "FATAL" in res["stderr"][r]:
            raise AssertionError(f"{label}: rank {r} printed a FATAL line")
    return survivors


def _final_params(res, r):
    with np.load(os.path.join(res["dir"], f"state-p{r}.npz")) as z:
        return {k: z[k] for k in z.files}


def _params_at(res, name, prefix):
    """The parameters ``state-<name>.npz`` keeps under ``prefix``
    (``final``, ``epoch<e>``: the state the first step of epoch e got)."""
    with np.load(os.path.join(res["dir"], f"state-{name}.npz")) as z:
        return {k.split("/", 1)[1]: z[k] for k in z.files
                if k.startswith(prefix + "/")}


def _hold_clean(label, res, clean, names, outs, epoch):
    """Each process's losses from ``epoch`` on and final parameters against
    the clean run's, bit for bit."""
    for i, (name, out) in enumerate(zip(names, outs)):
        after = [(x["step"], x["world"], x["loss"]) for x in out["losses"]
                 if x["epoch"] >= epoch]
        if [tuple(x) for x in clean[i]["losses"]] != after:
            raise AssertionError(f"{label}: {name}'s losses from epoch {epoch} "
                                 "differ from the clean run's")
        final = _params_at(res, name, "final")
        for k, v in clean[i]["params"].items():
            if final[k].tobytes() != v.tobytes():
                raise AssertionError(f"{label}: {name}'s final {k} is not the "
                                     "clean run's bit for bit")


def _drain_checks(label, res, left, stay, world, detail):
    if not res["ok"] or res["exit"] != [0, 0, 0, 0]:
        raise AssertionError(f"{label}: drill failed: exit {res['exit']}, "
                             f"stderr {[e[-800:] for e in res['stderr']]}")
    if res["completed"] != stay or res["drained"] != left:
        raise AssertionError(f"{label}: completed {res['completed']}, drained "
                             f"{res['drained']}")
    for r in range(4):
        out = res["results"][r]
        m = out["meters"]
        if (m.get("elastic.drain_incidents") != 1 or "watchdog.expiries" in m
                or "elastic.restores" in m or out["recoveries"]):
            raise AssertionError(f"{label}: rank {r}: meters {m}, recoveries "
                                 f"{out['recoveries']}")
    for r in stay:
        out = res["results"][r]
        if (out["final_world"] != world or out["epoch"] != 1
                or out["epoch_history"][0]["cause"] != "drain"
                or out["epoch_history"][0]["detail"] != detail):
            raise AssertionError(f"{label}: rank {r} ended at world "
                                 f"{out['final_world']}, {out['epoch_history']}")


def _clean_args(res, name, epoch, steps, rdv, port_base, grid=None,
                ef_state=True, lr=None):
    out = res["results"][int(name[1:])]
    start = out["restored_steps"][str(epoch)]
    return start, ("cuda:0", _params_at(res, name, f"epoch{epoch}"), start,
                   steps, rdv, port_base, grid, ef_state, lr)


def _finite_losses(label, res, names):
    for name in names:
        out = (res["results"][int(name[1:])] if name.startswith("p")
               else res["joiners"][0]["result"])
        if not np.isfinite([x["loss"] for x in out["losses"]]).all():
            raise AssertionError(f"{label}: {name}'s losses are not finite")


def _part(parts, name, t0, phase=13):
    parts[name] = time.perf_counter() - t0 - sum(parts.values())
    print(f"  phase {phase} part {name}: {parts[name]:.1f} s", flush=True)


def elastic_phase(dev, launch):
    """Phase 13 (see the module docstring); returns its summary, printed as
    one JSON line."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from mpi4jax_tpu_torch.models import elastic_training as ET

    t0 = time.perf_counter()
    steps, die, hang = 12, "die:rank=3:op=allreduce:after=5", \
        "hang:rank=2:op=allreduce:after=5"
    # (c), (e) and (h)'s width; the JAX example's lr 0.05 diverges there
    wide = {"dim": 1024, "hidden": 8192, "ef_state": False, "lr": 1e-3}
    out, parts = {}, {}
    with tempfile.TemporaryDirectory(prefix="mpx-elastic-") as tdir:
        # (a), (c), (e) and (h) side by side
        drills = ThreadPoolExecutor(4)
        # (a) the example twin at the JAX example's width, rank 3 dies
        fa_run = drills.submit(ET.launch, 4, steps=steps, device="cuda:0",
                             fault_spec=die, watchdog=1.0, limit=120.0,
                             workdir=os.path.join(tdir, "a"))
        # (c) the same loop with realistic state bytes: rank 3 dies in
        # step 5 (its 26th allreduce: 5 a step without the residual's
        # allgather), after the auto interval locked in at world 4
        fc_run = drills.submit(ET.launch, 4, steps=steps, device="cuda:0",
                             fault_spec="die:rank=3:op=allreduce:after=25",
                             watchdog=1.0, limit=300.0, commit_every="auto",
                             workdir=os.path.join(tdir, "c"), **wide)
        # (e) a real SIGTERM to rank 3 after its step 5, at (c)'s width:
        # announced at boundary 6, drained at 7 off the commit_every=4
        # cadence (a forced commit)
        fe_run = drills.submit(ET.launch, 4, steps=steps, device="cuda:0",
                             fault_spec="", sigterm=(3, 5), watchdog=1.0,
                             commit_every="4",
                             env={"MPI4JAX_TPU_TELEMETRY": "counters"},
                             expect_world=3, limit=180.0,
                             workdir=os.path.join(tdir, "e"), **wide)
        # (h) 4 -> 3 -> 4 at (c)'s width: rank 3 dies, its replacement is
        # admitted at the next commit boundary after it knocked (the
        # survivors wait for the knock in the first step at world 3)
        grow_steps = 32
        fh_run = drills.submit(ET.launch, 4, steps=grow_steps, device="cuda:0",
                             fault_spec="die:rank=3:op=allreduce:after=25",
                             grow=True, commit_every="auto", watchdog=1.0,
                             wait_for_join=90.0, expect_world=4, limit=300.0,
                             workdir=os.path.join(tdir, "h"), **wide)
        a = fa_run.result()
        survivors = _check_drill("(a)", a, 3, 13, steps)
        _recovery_line("(a)", a, survivors)
        restored_step = a["results"][0]["restored_step"]
        with np.load(os.path.join(a["dir"], "state-p0.npz")) as z:
            restored = {k.split("/", 1)[1]: z[k] for k in z.files
                        if k.startswith("restored/")}
        out["a"] = {"seconds": a["seconds"], "restored_step": restored_step,
                    "recoveries": {r: a["results"][r]["recoveries"][0]
                                   for r in survivors},
                    "losses_rank0": a["results"][0]["losses"],
                    "first_step_world3_s": {
                        r: next(x["seconds"] for x in a["results"][r]["losses"]
                                if x["epoch"] == 1) for r in survivors}}
        _part(parts, "a", t0)

        c = fc_run.result()
        survivors_c = _check_drill("(c)", c, 3, 13, steps)
        _finite_losses("(c)", c, [f"p{r}" for r in survivors_c])
        r0 = c["results"][0]
        n_params = 1024 * 8192 + 8192 + 8192 + 1
        state_bytes = 4 * n_params
        shard = -(-state_bytes // 4)
        w4 = [x["seconds"] for x in r0["losses"] if x["world"] == 4]
        w3 = [x["seconds"] for x in r0["losses"] if x["world"] == 3][1:]
        rec = r0["recoveries"][0]
        out["c"] = {
            "params": n_params, "state_bytes": state_bytes,
            "shard_bytes_world4": shard, "held_world4": 2,
            "last_commit": r0["last_commit"],
            "step_s_world4": w4, "step_s_world3_median": float(np.median(w3)),
            "commit_s": {r: c["results"][r]["last_commit_s"] for r in survivors_c},
            "restore_exchange_s": {r: c["results"][r]["recoveries"][0]["restore_s"]
                                   for r in survivors_c},
            "auto_commit_every": {r: c["results"][r]["auto_commit_every"]
                                  for r in survivors_c},
            "recovery_rank0": rec, "seconds": c["seconds"]}
        if r0["last_commit"]["state_bytes"] != state_bytes:
            raise AssertionError(f"(c): committed {r0['last_commit']} bytes, "
                                 f"expected {state_bytes}")
        print(f"  (c) {n_params} f32 ({state_bytes / 1e6:.1f} MB), redundancy 1: "
              f"{2 * shard / 1e6:.1f} MB held a rank at world 4; step "
              f"{np.median(w4[1:]) * 1e3:.1f} ms at world 4, "
              f"{out['c']['step_s_world3_median'] * 1e3:.1f} ms at world 3; "
              f"commit (device to host and pack) "
              f"{r0['last_commit_s'] * 1e3:.1f} ms; restore exchange over 3 "
              f"ranks {rec['restore_s'] * 1e3:.1f} ms; commit_every='auto' "
              f"locked in {r0['auto_commit_every']}")
        _part(parts, "c", t0)

        drills.shutdown(wait=False)
        e = fe_run.result()
        _drain_checks("(e)", e, [3], [0, 1, 2], 3, "drained rank(s) [3] of 4")
        _finite_losses("(e)", e, ["p0", "p1", "p2"])
        notice = e["results"][3]["drains"][0]
        out["e"] = {"seconds": e["seconds"], "notify_s": notice["notify_s"],
                    "unacked": notice["unacked"], "survivors": {}}
        for r in range(3):
            res_r = e["results"][r]
            drain = res_r["drains"][-1]
            if not drain["forced"] or drain["step"] != 7:
                raise AssertionError(f"(e): rank {r} drained {drain}")
            by_step = {(x["step"], x["epoch"]): x for x in res_r["losses"]}
            between, first3 = by_step[(6, 0)], by_step[(7, 1)]
            total = first3["at"] + first3["seconds"] - drain["notice_at"]
            out["e"]["survivors"][r] = {
                "notice_to_first_step_world3_s": total,
                "forced_commit_s": drain["commit_s"],
                "rebootstrap_s": drain["rebootstrap_s"],
                "step_between_s": between["seconds"],
                "first_step_world3_s": first3["seconds"]}
            print(f"  (e) rank {r}: notice to the end of the first step at "
                  f"world 3 {total * 1e3:.1f} ms: forced commit "
                  f"{drain['commit_s'] * 1e3:.1f} ms, the leaver's "
                  f"notify_drain (acks) {notice['notify_s'] * 1e3:.1f} ms, "
                  f"step 6 {between['seconds'] * 1e3:.1f} ms, re-bootstrap "
                  f"{drain['rebootstrap_s'] * 1e3:.1f} ms, first step at "
                  f"world 3 {first3['seconds'] * 1e3:.1f} ms")
        _part(parts, "e", t0)

        h = fh_run.result()
        if (not h["ok"] or h["exit"][:3] != [0, 0, 0] or len(h["joiners"]) != 1
                or h["joiners"][0]["exit"] != 0
                or h["completed"] != [0, 1, 2, "join0"]):
            raise AssertionError(
                f"(h): drill failed: exit {h['exit']}, joiners "
                f"{[(j['exit'], j['stderr'][-800:]) for j in h['joiners']]}, "
                f"stderr {[x[-800:] for x in h['stderr']]}")
        joiner = h["joiners"][0]["result"]
        jname = f"j{joiner['joined']['process_id']}"
        _finite_losses("(h)", h, ["p0", "p1", "p2", jname])
        finals = [_params_at(h, f"p{r}", "final") for r in range(3)]
        finals.append(_params_at(h, jname, "final"))
        for f in finals[1:]:
            for k, v in finals[0].items():
                if f[k].tobytes() != v.tobytes():
                    raise AssertionError(f"(h): the four final {k} differ")
        if joiner["origin"] != 4 or joiner["final_world"] != 4:
            raise AssertionError(f"(h): joiner {joiner['origin']}, "
                                 f"{joiner['final_world']}")
        grow0 = h["results"][0]["grows"][0]
        spawn_to_step = joiner["losses"][0]["at"] - h["joiners"][0]["spawned_at"]
        h4 = [x["seconds"] for x in h["results"][0]["losses"]
              if x["world"] == 4 and x["epoch"] == 2][1:]
        out["h"] = {"seconds": h["seconds"], "admitted_at": grow0["step"],
                    "grows": {r: h["results"][r]["grows"][0] for r in range(3)},
                    "joined": joiner["joined"],
                    "spawn_to_first_step_s": spawn_to_step,
                    "auto_commit_every": h["results"][0]["auto_commit_every"],
                    "step_s_world4_grow_on": h4,
                    "step_s_world4_grow_off_c": w4[1:],
                    "recovery_rank0": h["results"][0]["recoveries"][0]}
        h_bytes = h["results"][0]["last_commit"]["state_bytes"]
        for r in range(3):
            g = h["results"][r]["grows"][0]
            print(f"  (h) rank {r}: admitted 1 at step {g['step']}: poll "
                  f"{g['poll_s'] * 1e3:.2f} ms, admit {g['admit_s'] * 1e3:.1f} "
                  f"ms, rebootstrap_grow {g['rebootstrap_s'] * 1e3:.1f} ms, "
                  f"cold restore ({h_bytes / 1e6:.1f} MB, one uint8 "
                  f"allreduce) {g['restore_s'] * 1e3:.1f} ms")
        jj = joiner["joined"]
        print(f"  (h) joiner (launch rank {joiner['origin']}): spawn to its "
              f"first step {spawn_to_step:.2f} s (knock to admit "
              f"{jj['wait_s']:.2f} s, re-bootstrap "
              f"{jj['rebootstrap_s'] * 1e3:.1f} ms, cold restore "
              f"{jj['restore_s'] * 1e3:.1f} ms); a step at world 4 with the "
              f"grow flag on {np.median(h4) * 1e3:.1f} ms (median of "
              f"{len(h4)}), (c)'s with it off {np.median(w4[1:]) * 1e3:.1f} ms")
        _part(parts, "h", t0)

        # side by side (counts, verdicts and bits, not times): (b) the hang
        # drill, both parts of (d), (f) a row drain and (g) a row shrink by a
        # failure on (2,2), and the clean run (a) is held against
        row = {"MPI4JAX_TPU_TELEMETRY": "counters",
               "MPI4JAX_TPU_ELASTIC_FAIL_UNIT": "row"}
        pool = ThreadPoolExecutor(6)
        fa = pool.submit(launch.run, elastic_clean_rank, 3, backend="gloo",
                         device="cuda:0", timeout=300,
                         args=("cuda:0", restored, restored_step, steps,
                               "file://" + os.path.join(tdir, "clean"),
                               ET.free_port_base(3)))
        fb = pool.submit(ET.launch, 4, steps=steps, device="cuda:0",
                         fault_spec=hang, watchdog=1.0, limit=120.0,
                         workdir=os.path.join(tdir, "b"))
        fd = pool.submit(launch.run, elastic_megastep_rank, 4, backend="gloo",
                         device="cuda:0", timeout=300,
                         args=("cuda:0", "file://" + os.path.join(tdir, "d"),
                               ET.free_port_base(4), 4, steps))
        # (d) one rank, in a process of its own: it advances the epoch and
        # resets the pin counters
        f1 = pool.submit(launch.run, elastic_one_rank_graph, 1,
                         device=str(dev), timeout=120.0, args=(str(dev),))
        ff = pool.submit(ET.launch, 4, steps=steps, device="cuda:0",
                         fault_spec="preempt:rank=3:op=allreduce:after=5",
                         grid="2x2", watchdog=1.0, commit_every="4", env=row,
                         expect_world=2, limit=120.0,
                         workdir=os.path.join(tdir, "f"))
        fg = pool.submit(ET.launch, 4, steps=steps, device="cuda:0",
                         fault_spec="die:rank=3:op=allreduce:after=5",
                         grid="2x2", watchdog=1.0,
                         env=dict(row, MPI4JAX_TPU_ELASTIC_PLACEMENT="stripe",
                                  MPI4JAX_TPU_TOPOLOGY="2,2"),
                         expect_world=2, limit=120.0,
                         workdir=os.path.join(tdir, "g"))
        pool.shutdown(wait=True)
        clean = fa.result()
        after = [(x["step"], x["world"], x["loss"])
                 for x in a["results"][0]["losses"] if x["epoch"] == 1]
        finals = [_final_params(a, r) for r in survivors]
        for i, r in enumerate(survivors):
            if [tuple(x) for x in clean[i]["losses"]] != after:
                raise AssertionError(f"(a): rank {r}'s losses after the restore "
                                     "differ from the clean 3-rank run's")
            for k, v in clean[i]["params"].items():
                if (finals[i][f"final/{k}"].tobytes() != v.tobytes()
                        or finals[i][f"final/{k}"].tobytes()
                        != finals[0][f"final/{k}"].tobytes()):
                    raise AssertionError(f"(a): rank {r}'s final {k} is not the "
                                         "clean 3-rank run's bit for bit")
        print(f"  (a) survivors {survivors}: identical parameters, bit for bit "
              f"the clean 3-rank run's from the committed step {restored_step}; "
              f"{a['seconds']:.1f} s with start-up")
        b = fb.result()
        survivors_b = _check_drill("(b)", b, 2, -9, steps)
        _recovery_line("(b)", b, survivors_b)
        out["b"] = {"seconds": b["seconds"], "exit": b["exit"],
                    "recoveries": {r: b["results"][r]["recoveries"][0]
                                   for r in survivors_b}}
        d4 = fd.result()
        if "declared failed" not in d4[3].get("declared", ""):
            raise AssertionError(f"(d): rank 3 not declared failed: {d4[3]}")
        for r in range(3):
            res = d4[r]
            calls = [tuple(c) for c in res["calls"]]
            if (any(s % 4 for s, _ in calls) or res["world"] != 3
                    or res["epoch"] != 1 or res["pins"] < 2
                    or res["stale_raises"] < 1 or res["graph"]
                    or calls[:3] != [(0, 0), (4, 0), (4, 1)]
                    or res["w_sha"] != d4[0]["w_sha"]):
                raise AssertionError(f"(d): rank {r}: {res}")
        print(f"  (d) four ranks, compile_step(unroll=4): dispatched "
              f"{d4[0]['calls']}, pins {d4[0]['pins']}, stale refusals "
              f"{d4[0]['stale_raises']}, eager pins, world 3, epoch 1, the "
              "survivors' state equal")
        f, g = ff.result(), fg.result()
        _drain_checks("(f)", f, [2, 3], [0, 1], 2, "drained rank(s) [2, 3] of 4")
        if (not g["ok"] or g["exit"] != [0, 0, 3, 13] or g["completed"] != [0, 1]
                or "shrunk out with them" not in g["results"][2]["declared"]):
            raise AssertionError(f"(g): drill failed: exit {g['exit']}, "
                                 f"stderr {[x[-800:] for x in g['stderr']]}")
        for r in (0, 1):
            og = g["results"][r]
            if (og["final_world"] != 2 or og["recoveries"][0]["failed"] != [3]
                    or og["epoch_history"][0]["detail"]
                    != "shrank out rank(s) [2, 3] of 4"):
                raise AssertionError(f"(g): rank {r}: {og['epoch_history']}")
        out["f"] = {"seconds": f["seconds"], "drained": f["drained"],
                    "drain_step": f["results"][0]["drains"][-1]["step"]}
        out["g"] = {"seconds": g["seconds"], "exit": g["exit"],
                    "recovery_rank0": g["results"][0]["recoveries"][0]}
        _part(parts, "side_by_side", t0)

        # the clean runs (e), (h) and the (1,2) runs (f) and (g) are held
        # against, side by side once the drills have ended
        pool = ThreadPoolExecutor(4)
        runs = {}
        for label, res, epoch, n, size, grid, ef, lr in (
                ("e", e, 1, steps, 3, None, False, wide["lr"]),
                ("h", h, 2, grow_steps, 4, None, False, wide["lr"]),
                ("f", f, 1, steps, 2, (1, 2), True, ET.LR),
                ("g", g, 1, steps, 2, (1, 2), True, ET.LR)):
            start, args = _clean_args(
                res, "p0", epoch, n,
                "file://" + os.path.join(tdir, f"clean-{label}"),
                ET.free_port_base(size), grid, ef, lr)
            runs[label] = (start, pool.submit(
                launch.run, elastic_clean_rank, size, backend="gloo",
                device="cuda:0", timeout=300, args=args))
        pool.shutdown(wait=True)
        _hold_clean("(e)", e, runs["e"][1].result(), ["p0", "p1", "p2"],
                    [e["results"][r] for r in range(3)], 1)
        _hold_clean("(h)", h, runs["h"][1].result(), ["p0", "p1", "p2", jname],
                    [h["results"][r] for r in range(3)] + [joiner], 2)
        _hold_clean("(f)", f, runs["f"][1].result(), ["p0", "p1"],
                    [f["results"][r] for r in (0, 1)], 1)
        _hold_clean("(g)", g, runs["g"][1].result(), ["p0", "p1"],
                    [g["results"][r] for r in (0, 1)], 1)
        print(f"  (e) the survivors from the forced commit at step "
              f"{runs['e'][0]}, (h) all four from the admission at step "
              f"{runs['h'][0]}, (f) ranks 0, 1 from the forced commit at "
              f"{runs['f'][0]} on (1,2) after ranks 2, 3 drained, (g) ranks "
              f"0, 1 from the restore at {runs['g'][0]} on (1,2) with rank 2 "
              "shrunk out with rank 3: each bit for bit a clean run of that "
              "world")
        _part(parts, "clean_runs", t0)

    # (d) one rank: a graph pin, stale across advance_epoch(), re-pinned
    out["d"] = {"four_ranks": d4[0], "one_rank": f1.result()[0]}
    print(f"  (d) one rank: graph pin, {out['d']['one_rank']['stale']} after "
          "advance_epoch(), re-pinned as a graph, both bit for bit with the "
          "eager iterations")
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = parts
    print(f"phase 13 (elastic): {out['seconds']:.1f} s; by part "
          + json.dumps({k: round(v, 1) for k, v in parts.items()}))
    return out


def elastic_main():
    """``python3 chip_smoke.py --elastic``: phase 13 alone (it launches no
    kernel, so nothing is built); one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    from mpi4jax_tpu_torch.parallel import launch

    out = elastic_phase(torch.device("cuda"), launch)
    print(smi)
    print(json.dumps({"elastic": out}, default=str))
    return 0


# ---------------------------------------------------------------------------
# phase 14: the parallel workloads.  The expert-parallel MoE layer and the
# pipeline schedule compiler on four gloo ranks on this card; no kernel of
# the table runs (their products are cuBLAS calls, as the JAX package's are
# XLA dots outside any Pallas kernel).  All three parts run in one launch.
# ---------------------------------------------------------------------------

# (b): the training block's width (PERF.md section 4), the (2,2) training
# cell's 2 x 2048 tokens a rank, 4 experts at factor 1.25: capacity 1280
MOE_WIDE = {"tokens": 4096, "d": 1024, "d_ff": 2048, "factor": 1.25, "seed": 0}
# (c): 8 tanh substages at DIM 1024 (2 a rank), batch 512 in 16
# microbatches of 32 rows (128 KiB boundary messages)
PIPE_WIDE = {"batch": 512, "dim": 1024, "microbatches": 16}
WORK_RTOL, WORK_ATOL = 1e-5, 1e-6   # tests/test_moe.py:72
WORK_REPS = 5


def _wall_ms(dev, fn, reps):
    """Mean host wall of ``fn()`` over ``reps`` calls after one, the card
    synchronised around them (every rank runs it in lock-step)."""
    fn()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3 / reps


def moe_wide_rank(rank, device):
    """(b) on one rank: the layer at ``MOE_WIDE`` against the single-GPU
    fold of ``reference_moe``'s math (``moe.fold_layer`` on CUDA), chunks 2
    and 4 against 1, the ms a layer and a forward + backward, and the
    exchanges of one synchronous layer."""
    from mpi4jax_tpu_torch import Comm, make_world_mesh, spmd
    from mpi4jax_tpu_torch.ops import _staging
    from mpi4jax_tpu_torch.parallel import moe

    mesh = make_world_mesh(device=device)
    comm = Comm(mesh.axes[0], mesh=mesh)
    dev, k = mesh.device, comm.Get_size()
    c = MOE_WIDE
    cap = moe.capacity_for(c["tokens"], k, c["factor"])
    rng = np.random.default_rng(c["seed"])
    x_all = torch.from_numpy(rng.standard_normal(
        (k, c["tokens"], c["d"]), dtype=np.float32)).to(dev)
    params_all = [moe.MoEParams(*(torch.from_numpy(a).to(dev) for a in
                                  moe.init_moe_params(c["d"], c["d_ff"], k,
                                                      rank=r, seed=c["seed"])))
                  for r in range(k)]
    x, params = x_all[rank], params_all[rank]
    ref = moe.fold_layer(torch, x_all, params_all, cap)[rank].clone()
    del x_all
    torch.cuda.empty_cache()

    def layer(chunks, p=params):
        return spmd(lambda xv: moe.moe_layer(xv, p, comm=comm, chunks=chunks,
                                             capacity_factor=c["factor"])[0],
                    comm=comm)(x)

    out = {"capacity": cap, "dispatch_bytes": int(c["tokens"] * k * cap * 4),
           "bucket_bytes": int(k * cap * c["d"] * 4)}
    ys = {ch: layer(ch) for ch in (1, 2, 4)}
    out["finite"] = bool(torch.isfinite(ys[1]).all())
    out["ref_max_abs_err"] = (ys[1] - ref).abs().max().item()
    out["ref_in_band"] = bool(torch.allclose(ys[1], ref, rtol=WORK_RTOL,
                                             atol=WORK_ATOL))
    out["ref_bitwise"] = bool(torch.equal(ys[1], ref))
    for ch in (2, 4):
        out[f"chunks{ch}_bitwise"] = bool(torch.equal(ys[ch], ys[1]))
        out[f"chunks{ch}_max_abs_err"] = (ys[ch] - ys[1]).abs().max().item()
        out[f"chunks{ch}_in_band"] = bool(torch.allclose(
            ys[ch], ys[1], rtol=WORK_RTOL, atol=WORK_ATOL))
    del ys, ref
    out["ms"] = {f"chunks{ch}": _wall_ms(dev, lambda ch=ch: layer(ch), WORK_REPS)
                 for ch in (1, 2, 4)}
    _staging.stats.reset()
    layer(1)
    torch.cuda.synchronize(dev)
    out["sync_layer_exchange"] = {"calls": _staging.stats.calls,
                                  "staged_bytes": _staging.stats.staged_bytes,
                                  "seconds": _staging.stats.seconds}

    def fwd_bwd():
        w_in = params.w_in.detach().requires_grad_(True)
        w_out = params.w_out.detach().requires_grad_(True)
        p = params._replace(w_in=w_in, w_out=w_out)

        def body(xv):
            with torch.enable_grad():
                y = moe.moe_layer(xv, p, comm=comm, chunks=1,
                                  capacity_factor=c["factor"])[0]
                return torch.autograd.grad(torch.sum(y * y), (w_in, w_out))

        return spmd(body, comm=comm)(x)

    out["fwd_bwd_ms"] = _wall_ms(dev, fwd_bwd, WORK_REPS)
    return out


def pipeline_wide_rank(rank, device):
    """(c) on one rank: the pipeline twin at ``PIPE_WIDE`` (the ladder and
    the four schedules, each bit for bit against the sequential
    reference on the last rank, the best ms a round of ``WORK_REPS``), then
    each schedule once under ``counters``: the measured bubble fraction
    beside the plan's ``(warmup + cooldown) / ticks``."""
    from mpi4jax_tpu_torch import Comm, make_world_mesh, telemetry
    from mpi4jax_tpu_torch.models import pipeline_parallel as PP
    from mpi4jax_tpu_torch.parallel.pipeline import pipeline, split_microbatches

    c = PIPE_WIDE
    res = PP.main(device, batch=c["batch"], dim=c["dim"],
                  microbatches=c["microbatches"], runs=WORK_REPS)
    mesh = make_world_mesh(device=device)
    comm = Comm(mesh.axes[0], mesh=mesh)
    dev, stages = mesh.device, comm.Get_size()
    x0, ws = (torch.from_numpy(a).to(dev) for a in PP.build_inputs(stages, c["batch"],
                                                                  c["dim"]))
    w2, wi = (t.contiguous() for t in PP.stage_weights(ws, stages, rank))
    mbs = split_microbatches(x0 if rank == 0 else torch.zeros_like(x0),
                             c["microbatches"])
    bubble = {}
    for label, prog, params in (
        ("gpipe", pipeline(PP.stage_pair, c["microbatches"], schedule="gpipe",
                           comm=comm), w2),
        ("1f1b", pipeline(PP.stage_pair, c["microbatches"], schedule="1f1b",
                          comm=comm), w2),
        ("interleaved", pipeline(PP.substage, c["microbatches"],
                                 schedule="interleaved", virtual=2, comm=comm), wi),
        ("auto", pipeline(PP.stage_pair, c["microbatches"], comm=comm), w2),
    ):
        prog(mbs, params)  # warm
        telemetry.set_telemetry_mode("counters")
        try:
            telemetry.reset()
            prog(mbs, params)
            meters = telemetry.snapshot()["meters"]
        finally:
            telemetry.set_telemetry_mode(None)
            telemetry.reset()
        plan = res["plans"][label]
        stage_us, wait_us = meters.get("pipeline.stage_us", 0), \
            meters.get("pipeline.bubble_wait_us", 0)
        bubble[label] = {
            "stage_us": stage_us, "bubble_wait_us": wait_us,
            "measured": wait_us / max(1, stage_us + wait_us),
            "plan": (plan["warmup"] + plan["cooldown"]) / plan["ticks"],
            "schedule": plan["schedule"]}
    return {"ms": res["ms"], "plans": res["plans"], "last": res["last"],
            "bubble": bubble,
            "boundary_bytes": (c["batch"] // c["microbatches"]) * c["dim"] * 4}


def workloads_rank(rank, device):
    """Phase 14's three parts on one rank of one launch."""
    from mpi4jax_tpu_torch.models import moe_training as MT

    torch.backends.cuda.matmul.allow_tf32 = False
    out, t = {}, time.perf_counter()
    twin = MT.main(device)  # (a): raises where the pin fails
    out["a"] = {"losses": twin["losses"], "capacity": twin["capacity"],
                "seconds": time.perf_counter() - t}
    t = time.perf_counter()
    out["b"] = moe_wide_rank(rank, device)
    out["b"]["seconds"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["c"] = pipeline_wide_rank(rank, device)
    out["c"]["seconds"] = time.perf_counter() - t
    return out


def workloads_phase(dev, launch, smi):
    """Phase 14 (see the module docstring); returns its summary, printed as
    one JSON line."""
    t0 = time.perf_counter()
    ranks = launch.run(workloads_rank, 4, backend="gloo", device="cuda:0",
                       timeout=600, args=("cuda:0",))
    a = [r["a"] for r in ranks]
    losses = a[0]["losses"]
    if any(r["losses"] != losses for r in a) or not all(
            np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"phase 14 (a): losses {[r['losses'] for r in a]}")
    print(f"phase 14 (a) MoE twin (tokens 32, d 16, d_ff 32, 4 experts, capacity "
          f"{a[0]['capacity']}): overlapped == synchronous bit for bit on every "
          "rank; losses " + " -> ".join(f"{v:.5f}" for v in losses))
    b = [r["b"] for r in ranks]
    for r, rb in enumerate(b):
        # the pin: chunks 2 and 4 give the synchronous layer's bits
        if not (rb["finite"] and rb["ref_in_band"] and rb["chunks2_bitwise"]
                and rb["chunks4_bitwise"]):
            raise AssertionError(f"phase 14 (b) rank {r}: {rb}")
    b0 = b[0]
    print(f"phase 14 (b) MoE layer at d {MOE_WIDE['d']}, d_ff {MOE_WIDE['d_ff']}, "
          f"{MOE_WIDE['tokens']} tokens a rank, "
          f"capacity {b0['capacity']} (dispatch tensor {b0['dispatch_bytes'] / 1e6:.1f}"
          f" MB, buckets {b0['bucket_bytes'] / 1e6:.1f} MB a direction): every "
          "rank against the single-GPU fold, max|diff| "
          f"{max(rb['ref_max_abs_err'] for rb in b):.3e} (bitwise on "
          f"{sum(rb['ref_bitwise'] for rb in b)}/4 ranks); chunks 2 and 4 against "
          f"1 bitwise on {sum(rb['chunks2_bitwise'] for rb in b)}/4 and "
          f"{sum(rb['chunks4_bitwise'] for rb in b)}/4 ranks, max|diff| "
          f"{max(max(rb['chunks2_max_abs_err'], rb['chunks4_max_abs_err']) for rb in b):.3e}")
    print(f"  rank 0 ms a layer: sync {b0['ms']['chunks1']:.2f}, chunks 2 "
          f"{b0['ms']['chunks2']:.2f}, chunks 4 {b0['ms']['chunks4']:.2f}; forward + "
          f"backward {b0['fwd_bwd_ms']:.2f} ms; one sync layer: "
          f"{b0['sync_layer_exchange']['staged_bytes'] / 1e6:.1f} MB staged in "
          f"{b0['sync_layer_exchange']['calls']} exchanges, "
          f"{b0['sync_layer_exchange']['seconds'] * 1e3:.2f} ms inside them")
    c = [r["c"] for r in ranks]
    if not c[-1]["last"]:
        raise AssertionError("phase 14 (c): rank 3 is not the last stage")
    c3 = c[-1]
    print(f"phase 14 (c) pipeline, 8 tanh substages at DIM {PIPE_WIDE['dim']}, batch "
          f"{PIPE_WIDE['batch']} in {PIPE_WIDE['microbatches']} microbatches "
          f"({c3['boundary_bytes'] // 1024} KiB boundaries): the ladder and every "
          "schedule bit for bit against the sequential single-GPU reference on the "
          "last rank")
    for label, ms in c3["ms"].items():
        bub = c3["bubble"].get(label)
        extra = "" if bub is None else (
            f"; {bub['schedule']}: measured bubble {bub['measured']:.1%} beside "
            f"the plan's {bub['plan']:.1%}")
        print(f"  {label:<12} {ms:8.2f} ms a round (rank 3, best of {WORK_REPS})"
              + extra)
    print(f"  {smi}: four processes share this one card through gloo and host "
          "memory, so no number of phase 14 is a scaling result")
    out = {"a": {"losses": losses, "seconds": a[0]["seconds"]},
           "b": {"rank0": b0, "ranks": [{k: v for k, v in rb.items()
                                         if k.endswith(("bitwise", "err"))}
                                        for rb in b]},
           "c": {"rank3": c3, "rank0_ms": c[0]["ms"]},
           "card": smi, "seconds": time.perf_counter() - t0}
    print(f"phase 14 (workloads): {out['seconds']:.1f} s")
    return out


def workloads_main():
    """``python3 chip_smoke.py --workloads``: phase 14 alone (it launches no
    kernel, so nothing is built); one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    from mpi4jax_tpu_torch.parallel import launch

    out = workloads_phase(torch.device("cuda"), launch, smi)
    print(smi)
    print(json.dumps({"workloads": out}, default=str))
    return 0


# ---------------------------------------------------------------------------
# phase 15: the serving runtime.  The twin's bench preset (d 1536, heads 24
# of 64, ffn 6144, max_len 160) on this card under both schedulers, the
# token streams under three schedules and on the CPU, and the drain drill on
# four gloo ranks; no kernel of the table runs (the decoder's products and
# attention are cuBLAS calls and PyTorch ops, as the JAX package's are XLA
# dots and einsums outside any Pallas kernel).
# ---------------------------------------------------------------------------

SERVE_REPS, SERVE_WARMUP = 20, 3
# a greedy token whose top-2 logit gap is inside this f32 band of the
# logits' magnitude is a tie that the last bit of a sum decides
TIE_RTOL, TIE_ATOL = 1e-5, 1e-6


def _one_rank_comm(device):
    from mpi4jax_tpu_torch import Comm, make_world_mesh

    mesh = make_world_mesh(device=device)
    return Comm(mesh.axes[0], mesh=mesh)


def serving_program_ms(engine):
    """(a)'s per-bucket times from CUDA events: one decode megastep (its
    graph replayed on its own donated carry, the lengths growing by the
    unroll a call) and one prefill (with the pin's copies in and out), each
    on every lane of the bucket live; and the decode megastep's floor, its
    parameter bytes read once a token step."""
    cfg = engine.cfg
    dev = engine.device
    param_bytes = sum(t.numel() * t.element_size() for t in engine._state[:5])
    out = {}
    for b in engine.table.buckets:
        lane = torch.arange(b, dtype=torch.int32, device=dev)
        dec = engine._state + (torch.ones(b, dtype=torch.int32, device=dev),
                               torch.full((b,), cfg.max_prompt, dtype=torch.int32,
                                          device=dev), lane)
        prog = engine._program("decode", b, dec)
        carry = [prog(*dec)]

        def step():
            carry[0] = prog(*carry[0])

        dec_ms = time_ms(step, SERVE_REPS, SERVE_WARMUP)
        prompts = torch.randint(1, cfg.vocab, (b, cfg.max_prompt), dtype=torch.int32,
                                device=dev)
        pre = engine._state + (prompts, torch.full((b,), cfg.max_prompt,
                                                   dtype=torch.int32, device=dev),
                               lane)
        pprog = engine._program("prefill", b, pre)
        pre_ms = time_ms(lambda: pprog(*pre), SERVE_REPS, SERVE_WARMUP)
        out[b] = {"decode_megastep_ms": dec_ms, "prefill_ms": pre_ms,
                  "decode_graph": prog.graph, "prefill_graph": pprog.graph,
                  "decode_bytes_copied": prog.bytes_copied,
                  "decode_floor_ms": bound_ms(cfg.unroll * param_bytes, 0)[0]}
    return out


def serving_one_gpu(dev, smi):
    """(a): the bench preset under continuous and then static on one GPU
    (wall clock), after one untimed pass that captures the programs."""
    from mpi4jax_tpu_torch.models import serving as MS

    cfg = MS.make_config("bench")
    trace, meta = MS.make_trace(cfg)
    comm = _one_rank_comm(dev)
    t0 = time.perf_counter()
    payload, engine, runs = MS.benchmark(cfg, trace, meta, comm)
    budgets = {r.rid: r.max_new_tokens for r in trace}
    for sched, run in runs.items():
        res = run["result"]
        if (res["failed"] or res["completed"] != len(trace)
                or {rid: len(s) for rid, s in run["streams"].items()} != budgets):
            raise AssertionError(f"phase 15 (a) {sched}: {res}")
    if not all(payload["graphs"].values()):
        raise AssertionError(f"phase 15 (a): a program is not a CUDA graph: "
                             f"{payload['graphs']}")
    programs = sorted(payload["graphs"])
    ms = serving_program_ms(engine)
    params_mb = sum(t.numel() * 4 for t in engine._state[:5]) / 1e6
    kv_mb = sum(t.numel() * 4 for t in engine._state[5:7]) / 1e6
    print(f"phase 15 (a) serving, bench preset (d {cfg.dim}, {cfg.heads} heads of "
          f"{cfg.head_dim}, ffn {cfg.ffn}, max_len {cfg.max_len}; {params_mb:.1f} MB "
          f"of f32 parameters, a {kv_mb:.1f} MB KV pool of {cfg.slots() + 1} rows), "
          f"{len(trace)} requests at {meta['rate_rps']}/s (seed {meta['seed']}, "
          f"long_frac {meta['long_frac']}, {meta['tokens_budgeted']} tokens), "
          f"unroll {cfg.unroll}, buckets {list(engine.table.buckets)}, one GPU, "
          f"wall clock ({smi}):")
    w = payload["warmup"]
    print(f"  warm-up pass (captures every program): wall {w['wall_s']:.3f} s")
    for sched, run in runs.items():
        r = run["result"]
        print(f"  {sched:>10}: {r['tokens_per_s_per_chip']} tokens/s/chip, p50 "
              f"{r['p50_ms']} ms, p99 {r['p99_ms']} ms, TTFT p99 {r['ttft_p99_ms']} "
              f"ms, wall {r['wall_s']} s, {r['boundaries']} boundaries, "
              f"{r['completed']} completed, {r['failed']} failed")
    print(f"  continuous over static: {payload.get('speedup_tokens_per_s')}x "
          f"tokens/s; programs pinned (each a CUDA graph): {', '.join(programs)}")
    for b, m in ms.items():
        print(f"  bucket {b}: decode megastep ({cfg.unroll} tokens) "
              f"{m['decode_megastep_ms']:.4f} ms (floor {m['decode_floor_ms']:.4f} "
              f"ms: the parameters read once a token), prefill "
              f"{m['prefill_ms']:.4f} ms with the pin's copies")
    return {"config": cfg.workload_meta(1), "trace": meta, "payload": payload,
            "programs": programs, "program_ms": ms,
            "seconds": time.perf_counter() - t0}


def serving_invariance(dev):
    """(b): each request's greedy stream under continuous unroll 4, static
    unroll 4, continuous unroll 1 on the card and continuous unroll 4 on the
    CPU (virtual clock).  A stream that differs is traced to its first
    differing token, where the top-2 logit gap says whether it is a tie the
    last bit decides (recorded) or a fault (raised)."""
    from mpi4jax_tpu_torch.models import serving as MS

    t0 = time.perf_counter()
    cuda, cpu = _one_rank_comm(dev), _one_rank_comm("cpu")
    trace, _ = MS.make_trace(MS.make_config("bench"))
    runs = {}
    for label, sched, unroll, comm in (("continuous,u4", "continuous", 4, cuda),
                                       ("static,u4", "static", 4, cuda),
                                       ("continuous,u1", "continuous", 1, cuda),
                                       ("cpu,continuous,u4", "continuous", 4, cpu)):
        cfg = MS.make_config("bench", unroll=unroll, virtual_clock=True)
        res, streams = MS.serve_streams(cfg, trace, comm, sched)
        if res["failed"] or res["completed"] != len(trace):
            raise AssertionError(f"phase 15 (b) {label}: {res}")
        runs[label] = streams
    base = runs["continuous,u4"]
    cfg = MS.make_config("bench", virtual_clock=True)
    prompts = {r.rid: r.prompt for r in trace}
    out = {"equal": {}, "ties": []}
    for label, streams in runs.items():
        if label == "continuous,u4":
            continue
        diffs = MS.first_differences(base, streams)
        out["equal"][label] = len(trace) - len(diffs)
        for rid, i in diffs.items():
            history = tuple(prompts[rid]) + tuple(base[rid][:i])
            tie = {"run": label, "rid": rid, "index": i,
                   "tokens": (base[rid][i] if i < len(base[rid]) else None,
                              streams[rid][i] if i < len(streams[rid]) else None),
                   "gpu": MS.top2_gap(cfg, history, cuda),
                   "cpu": MS.top2_gap(cfg, history, cpu)}
            g = tie["gpu"]
            tie["in_band"] = g["gap"] <= TIE_RTOL * g["max_abs"] + TIE_ATOL
            out["ties"].append(tie)
            print(f"  (b) {label} request {rid}: first differing token {i} "
                  f"{tie['tokens']}, top-2 logit gap {g['gap']:.3e} of |logit| "
                  f"{g['max_abs']:.3e} on the card, {tie['cpu']['gap']:.3e} on the "
                  f"CPU: {'a tie of the last bit' if tie['in_band'] else 'A FAULT'}")
    print("phase 15 (b) token streams of the bench preset (virtual clock) against "
          "continuous unroll 4 on the card: " + ", ".join(
              f"{label} {n}/{len(trace)} equal" for label, n in out["equal"].items()))
    faults = [t for t in out["ties"] if not t["in_band"]]
    if faults:
        raise AssertionError(f"phase 15 (b): streams differ outside the f32 band: "
                             f"{faults}")
    out["seconds"] = time.perf_counter() - t0
    out["streams"] = base
    return out


def serving_drill(smi, device="cuda:0"):
    """(c): the drain drill 4 -> 3 at the bench preset on four gloo ranks on
    this card (rank 3 drained from boundary 4), beside a clean four-rank
    run of the same trace, the two launches side by side."""
    from concurrent.futures import ThreadPoolExecutor

    from mpi4jax_tpu_torch.models import serving as MS

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        fut = {name: pool.submit(MS.launch, 4, model="bench", drain_rank=rank,
                                 drain_boundary=4, device=device, limit=240)
               for name, rank in (("drill", 3), ("clean", MS.NO_DRAIN))}
        drill, clean = fut["drill"].result(), fut["clean"].result()
    for name, res in (("drill", drill), ("clean", clean)):
        if not res["ok"]:
            raise AssertionError(f"phase 15 (c) {name}: exits {res['exit']}, "
                                 f"stderr {[e[-2000:] for e in res['stderr']]}")
    if drill["drained"] != [3] or drill["completed"] != [0, 1, 2]:
        raise AssertionError(f"phase 15 (c): drained {drill['drained']}, "
                             f"completed {drill['completed']}")
    ref = clean["results"][0]["streams"]
    if any(r["streams"] != ref for r in clean["results"]):
        raise AssertionError("phase 15 (c): the clean ranks disagree")
    survivors = []
    for r in (0, 1, 2):
        rec = drill["results"][r]
        res = rec["result"]
        if (res["world"] != 3 or res["failed"] or res["completed"] != 24
                or res["preempt_readmissions"] <= 0):
            raise AssertionError(f"phase 15 (c) rank {r}: {res}")
        [change] = rec["world_changes"]
        [drain] = [d for d in rec["drains"] if not d.get("notice")]
        notice = drain["notice_at"]
        before = (change["boundary"] - 1) * rec["tick_s"] + 1e-9
        early = [rid for rid, f in rec["finish_s"].items() if f <= before]
        if any(rec["streams"][rid] != ref[rid] for rid in early):
            raise AssertionError(f"phase 15 (c) rank {r}: a stream finished "
                                 "before the drain differs from the clean run's")
        survivors.append({
            "rank": r, "world_change": change, "drain": drain,
            "notice_to_first_megastep_ms": (
                (rec["first_at_new_world"]["at"] - notice) * 1e3
                if notice is not None else None),
            "replay_prefill_ms": change["replay_s"] * 1e3,
            "rebuild_ms": change["rebuild_s"] * 1e3,
            "finished_before_drain": len(early),
            "streams_equal_clean": sum(rec["streams"][rid] == ref[rid] for rid in ref),
            "readmissions": res["preempt_readmissions"], "wall": rec["wall"]})
    s0 = survivors[0]
    print(f"phase 15 (c) drain drill, bench preset, four gloo ranks on this card "
          f"4 -> 3 (rank 3 drained at boundary {drill['results'][3]['posted'][0]['boundary']}"
          f", the world changed at boundary {s0['world_change']['boundary']}): every "
          f"worker exit 0, survivors at world 3 with 24/24 completed, 0 failed, "
          f"{s0['readmissions']} re-admitted; launches {drill['seconds']:.1f} s "
          f"(drill) and {clean['seconds']:.1f} s (clean), side by side")
    for s in survivors:
        ms = s["notice_to_first_megastep_ms"]
        print(f"  rank {s['rank']}: notice to the first megastep at world 3 "
              f"{'-' if ms is None else f'{ms:.1f}'} ms (rebuild "
              f"{s['rebuild_ms']:.1f} ms, replay prefill {s['replay_prefill_ms']:.1f} ms"
              f" of {s['world_change']['readmitted']} sequences); "
              f"{s['streams_equal_clean']}/24 streams equal the clean run's, the "
              f"{s['finished_before_drain']} finished before the drain bit for bit")
    print(f"  {smi}: four processes share this one card through gloo and host "
          "memory, so no number of (c) is a scaling result")
    return {"survivors": survivors, "drill_seconds": drill["seconds"],
            "clean_seconds": clean["seconds"],
            "leaver": {k: drill["results"][3][k] for k in ("posted", "result")},
            "seconds": time.perf_counter() - t0}


def serving_phase(dev, smi):
    """Phase 15 (see the module docstring); returns its summary, printed as
    one JSON line."""
    t0 = time.perf_counter()
    a = serving_one_gpu(dev, smi)
    torch.cuda.empty_cache()
    b = serving_invariance(dev)
    torch.cuda.empty_cache()
    c = serving_drill(smi)
    out = {"a": a, "b": b, "c": c, "card": smi,
           "seconds": time.perf_counter() - t0}
    print(f"phase 15 (serving): {out['seconds']:.1f} s; (a) {a['seconds']:.1f}, "
          f"(b) {b['seconds']:.1f}, (c) {c['seconds']:.1f}")
    return out


def serving_main():
    """``python3 chip_smoke.py --serving``: phase 15 alone (it launches no
    kernel, so nothing is built); one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = serving_phase(torch.device("cuda"), smi)
    out["b"].pop("streams")
    print(smi)
    print(json.dumps({"serving": out}, default=str))
    return 0


# ---------------------------------------------------------------------------
# phase 16: the persistent tier
# ---------------------------------------------------------------------------


def kernel_specs(K, KP, KW, FA):
    """The seven kernel builds, one ``nvcc`` each."""
    return [K.spec(), KP.spec(), KW.spec(), FA.fwd_tf32_spec(), FA.tf32_spec(),
            FA.mma_spec(), FA.fwd_mma_spec()]


def tier_build(K, KP, KW, FA, tier):
    """Phase 16 (a): the main build with ``MPI4JAX_TPU_COMPILE_CACHE_DIR``
    set to ``tier`` (a fresh directory), then unset: every library the
    build makes is written to the tier.  Returns the libraries, the host
    library's path, the seconds and the tier's counters."""
    from pathlib import Path

    from mpi4jax_tpu_torch import native
    from mpi4jax_tpu_torch.aot import diskcache
    from mpi4jax_tpu_torch.kernels import _build

    os.environ["MPI4JAX_TPU_COMPILE_CACHE_DIR"] = tier
    try:
        t0 = time.perf_counter()
        specs = kernel_specs(K, KP, KW, FA)
        libs = _build.build_many(specs)
        seconds = time.perf_counter() - t0
        host = native.build(verbose=False)
        # a library this checkout had built already was not compiled, so not
        # stored: store it, so that the tier holds all eight
        local = [(_build.library_key(*spec), lib) for spec, lib in zip(specs, libs)]
        local.append((native.library_key(), Path(host)))
        local = [(key, lib) for key, lib in local
                 if not os.path.exists(diskcache._path_for(diskcache.cache_root(), key))]
        for key, lib in local:
            _build.to_tier(key, lib)
        st = {k: v for k, v in diskcache.stats().items() if k != "dir"}
    finally:
        del os.environ["MPI4JAX_TPU_COMPILE_CACHE_DIR"]
    compiles = _build.stats()["compiles"] + native.stats()["compiles"]
    if local:
        print(f"phase 16 (a): {len(local)} librar(ies) found built in the checkout "
              "were stored as they were")
    print(f"built {', '.join(p.name for p in libs)} in {seconds:.1f} s")
    print(f"built the host library {host}")
    print(f"phase 16 (a) the build through the persistent tier: {compiles} compiler "
          f"invocations, {st['writes']} artifacts written ({st['bytes']} bytes), "
          f"{st['misses']} misses")
    return libs, host, {"build_s": seconds, "compiles": compiles, **st}


# a fresh process with an empty build directory and the tier of (a): it
# builds every kernel and the host library from the tier, launches each
# kernel once against its plain version, and pins the sw_steps pair
AOT_COLD = r'''
import json, sys, time
t_start = time.perf_counter()
from pathlib import Path
import torch
from mpi4jax_tpu_torch import native
from mpi4jax_tpu_torch.kernels import _build
_build.BUILD_DIR = native.BUILD_DIR = Path(sys.argv[1])
import chip_smoke as CS
import mpi4jax_tpu_torch as tpx
from mpi4jax_tpu_torch.aot import diskcache
from mpi4jax_tpu_torch.kernels import flash_attention as FA
from mpi4jax_tpu_torch.kernels import sw_phase as KP
from mpi4jax_tpu_torch.kernels import sw_steps as K
from mpi4jax_tpu_torch.kernels import sw_wide as KW
from mpi4jax_tpu_torch.models import shallow_water as P
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t0 = time.perf_counter()
libs = _build.build_many(CS.kernel_specs(K, KP, KW, FA))
native.build(verbose=False)
build_s = time.perf_counter() - t0
st = diskcache.stats()
out = {"build_s": build_s, "libraries": [p.name for p in libs],
       "compiles": _build.stats()["compiles"] + native.stats()["compiles"],
       "hits": st["hits"], "misses": st["misses"]}
out["kernels"] = CS.reloaded_kernels(P, K, KP, KW, FA, torch.device("cuda"))
cfg = P.Config(nx=3600, ny=1800)
s1 = K.sw_steps_plain(tuple(P.initial_state(cfg, device="cuda")), cfg, True, 1)
pin = tpx.compile(K.sw_steps, s1, cfg, False, 2, wrap=False, static_argnums=(1, 2, 3))
CS.compare("pinned sw_steps pair", K.sw_steps_plain(s1, cfg, False, 2), pin(s1),
           P.State._fields, exact=True)
torch.cuda.synchronize()
st = diskcache.stats()
out["pin"] = {"from_disk": pin.from_disk, "graph": pin.graph, "hits": st["hits"],
              "misses": st["misses"],
              "compiles": _build.stats()["compiles"] + native.stats()["compiles"]}
out["wall_s"] = time.perf_counter() - t_start
print(json.dumps(out))
'''


def _launched_once(counter, name, call):
    before = counter.launches
    got = call()
    torch.cuda.synchronize()
    if counter.launches != before + 1:
        raise AssertionError(f"{name}: {counter.launches - before} launches, expected 1")
    return got


def reloaded_kernels(P, K, KP, KW, FA, dev):
    """Phase 16 (b)'s checks, in the fresh process: each kernel launched
    once at its main path's shape against its plain version (the stencils
    bit for bit at 3600x1800, the flash kernels in the bands of
    ``tests/test_kernels.py`` at B=4, T=4096, H=8, D=128).  Returns each
    kernel's largest difference."""
    names, errs = P.State._fields, {}
    cfg = P.Config(nx=3600, ny=1800)
    s1 = K.sw_steps_plain(tuple(P.initial_state(cfg, device=dev)), cfg, True, 1)
    got = _launched_once(K.counter, "sw_steps", lambda: K.sw_steps(s1, cfg, False, 2))
    errs["sw_steps"] = compare("reloaded sw_steps pair", K.sw_steps_plain(s1, cfg, False, 2),
                               got, names, exact=True)
    p1 = KP.sw_phase1_plain(tuple(P.initial_state(cfg, device=dev)), cfg, True, (0, 0))
    got = _launched_once(KP.counter, "sw_phase", lambda: KP.sw_phase1(p1, cfg, False, (0, 0)))
    errs["sw_phase"] = compare("reloaded sw_phase1", KP.sw_phase1_plain(p1, cfg, False, (0, 0)),
                               got, names, exact=True)
    got = _launched_once(KP.counter, "sw_phase", lambda: KP.sw_phase2(p1[1], p1[2], cfg, (0, 0)))
    errs["sw_phase"] = max(errs["sw_phase"], compare(
        "reloaded sw_phase2", KP.sw_phase2_plain(p1[1], p1[2], cfg, (0, 0)), got, ("u", "v"),
        exact=True))
    wcfg = P.Config(nx=3600, ny=1800, periodic_x=False)
    _, comm = P.make_mesh_and_comm(wcfg, device=dev)
    m = P._margin_rows(2)
    wf, _ = P._wide_exchange(tuple(P.initial_state(wcfg, device=dev)), wcfg, comm, m,
                             P.create_token())
    off = (-(m - 1), -(m - 1))
    f1 = KW.sw_wide_plain(wf, wcfg, True, 1, off)
    sl = (slice(m - 1, m - 1 + wcfg.ny_local), slice(m - 1, m - 1 + wcfg.nx_local))
    got = _launched_once(KW.counter, "sw_wide", lambda: KW.sw_wide(f1, wcfg, False, 2, off))
    errs["sw_wide"] = compare("reloaded sw_wide pair",
                              [a[sl] for a in KW.sw_wide_plain(f1, wcfg, False, 2, off)],
                              [b[sl] for b in got], names, exact=True)
    b, t, h, d = ATTN_B, ATTN_T, ATTN_H, ATTN_D
    gen = torch.Generator(device=dev).manual_seed(16)
    q, k, v = (torch.randn((b, t, h, d), device=dev, generator=gen) for _ in range(3))
    scale = 1.0 / d**0.5
    fwd = fwd_counters(FA)
    for name, qq, kk, vv, causal, o_rel in (
            ("flash_fwd_tf32", q, k, v, False, FLASH_REL["o"]),
            ("flash_fwd_causal_tf32", q, k, v, True, FLASH_CAUSAL_O_REL),
            ("flash_fwd_mma", q.bfloat16(), k.bfloat16(), v.bfloat16(), False,
             FLASH_BF16_O_REL),
            ("flash_fwd_causal_mma", q.bfloat16(), k.bfloat16(), v.bfloat16(), True,
             FLASH_BF16_O_REL)):
        got = _launched_once(fwd[name], name, lambda: FA.flash_block_partials(
            qq, kk, vv, None, scale=scale, causal=causal))
        want = FA.block_partials_plain(qq, kk, vv, None, scale=scale, causal=causal)
        errs[name] = max(flash_compare(f"reloaded {name}", want, got, o_rel).values())
    bwd = bwd_counters(FA)
    for sfx, qq, kk, vv in (("tf32", q, k, v),
                            ("mma", q.bfloat16(), k.bfloat16(), v.bfloat16())):
        with torch.no_grad():
            _, mm, _ = FA.flash_block_partials(qq, kk, vv, None, scale=scale)
        g_o = torch.randn(qq.shape, device=dev, generator=gen).to(qq.dtype)
        g_l = torch.randn(mm.shape, device=dev, generator=gen)
        args = (qq, kk, vv, None, mm, g_o, g_l)
        dq = _launched_once(bwd[f"flash_bwd_dq_{sfx}"], f"flash_bwd_dq_{sfx}",
                            lambda: FA.flash_bwd_dq(*args, scale=scale))
        dk, dv = _launched_once(bwd[f"flash_bwd_dkv_{sfx}"], f"flash_bwd_dkv_{sfx}",
                                lambda: FA.flash_bwd_dkv(*args, scale=scale))
        e = bwd_compare(f"reloaded backward ({sfx})",
                        FA.block_partials_bwd_plain(*args, scale=scale), (dq, dk, dv),
                        qq.dtype)
        errs[f"flash_bwd_dq_{sfx}"] = e["dq"]
        errs[f"flash_bwd_dkv_{sfx}"] = max(e["dk"], e["dv"])
    return errs


# a new process that serves with the tier (c): the first request alone on
# the wall clock (its time to the first token includes the programs' pins),
# then the bench trace on the virtual clock (phase 15 (b)'s streams)
AOT_SERVE = r'''
import json, sys, time
spawned = float(sys.argv[1])
t_start = time.time()
import torch
torch.backends.cuda.matmul.allow_tf32 = False
import mpi4jax_tpu_torch as tpx
from mpi4jax_tpu_torch import serving
from mpi4jax_tpu_torch.models import serving as MS
cfg = MS.make_config("bench")
trace, _ = MS.make_trace(cfg)
t_ready = time.time()
first = serving.Request(rid=trace[0].rid, arrival_s=0.0, prompt=trace[0].prompt,
                        max_new_tokens=1)
res1 = serving.ServingEngine(cfg, None).run([first], scheduler="continuous")
t_first = time.time()
res, streams = MS.serve_streams(MS.make_config("bench", virtual_clock=True), trace,
                                None, "continuous")
st = tpx.cache_stats()
print(json.dumps({
    "interpreter_s": t_start - spawned, "imports_s": t_ready - t_start,
    "first_ttft_ms": res1["ttft_p99_ms"], "spawn_to_first_token_s": t_first - spawned,
    "completed": res["completed"], "failed": res["failed"],
    "streams": {str(k): [int(x) for x in v] for k, v in streams.items()},
    "disk_cache": {k: v for k, v in st["disk_cache"].items() if k != "dir"},
    "aot": st["aot"]}))
'''


def _json_run(args, env, timeout):
    """One ``python`` process in this checkout: its last stdout line as JSON
    (raises, with its stderr, when it fails)."""
    res = subprocess.run([sys.executable, *args], env=env, capture_output=True,
                         text=True, timeout=timeout)
    if res.returncode != 0:
        raise AssertionError(f"{args[:3]} exited {res.returncode}: {res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def _tier_env(tier):
    env = dict(os.environ, MPI4JAX_TPU_COMPILE_CACHE_DIR=tier)
    env["PYTHONPATH"] = os.getcwd() + os.pathsep + env.get("PYTHONPATH", "")
    return env


def aot_serving_step_twice(tdir):
    """(d): ``models/aot_serving_step.py`` twice with one fresh directory."""
    env = _tier_env(os.path.join(tdir, "step-tier"))
    args = ["-m", "mpi4jax_tpu_torch.models.aot_serving_step", "--json"]
    return [_json_run(args, env, 300) for _ in range(2)]


def aot_phase(K, tier, built, base_streams):
    """Phase 16 (see the module docstring); returns its summary, printed as
    one JSON line.  ``tier`` holds (a)'s libraries, ``built`` (a)'s
    counters, ``base_streams`` phase 15 (b)'s continuous unroll-4
    streams."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import mpi4jax_tpu_torch as tpx
    from mpi4jax_tpu_torch.models import shallow_water as P

    t0 = time.perf_counter()
    parts, out = {}, {"a": built}
    env = _tier_env(tier)
    # the record the fresh process reads: the same pin in this process, with
    # the tier set (its warm-up runs the sw_steps library of (a))
    os.environ["MPI4JAX_TPU_COMPILE_CACHE_DIR"] = tier
    try:
        cfg = P.Config(nx=3600, ny=1800)
        s1 = K.sw_steps_plain(tuple(P.initial_state(cfg, device="cuda")), cfg, True, 1)
        pin = tpx.compile(K.sw_steps, s1, cfg, False, 2, wrap=False,
                          static_argnums=(1, 2, 3))
        del s1
    finally:
        del os.environ["MPI4JAX_TPU_COMPILE_CACHE_DIR"]
    if not pin.graph or pin.from_disk:
        raise AssertionError(f"phase 16: the record's pin {pin!r}")
    with tempfile.TemporaryDirectory(prefix="mpx-aot-") as tdir:
        b = _json_run(["-c", AOT_COLD, os.path.join(tdir, "build")], env, 300)
        if (b["compiles"], b["hits"], b["misses"]) != (0, 8, 0):
            raise AssertionError(f"(b): {b['compiles']} compiler invocations, "
                                 f"{b['hits']} hits, {b['misses']} misses")
        if not (b["pin"]["from_disk"] and b["pin"]["graph"]
                and b["pin"]["compiles"] == 0 and b["pin"]["misses"] == 0):
            raise AssertionError(f"(b): the pinned sw_steps pair {b['pin']}")
        print(f"phase 16 (b) a fresh process, an empty build directory: 0 compiler "
              f"invocations, 8 hits, 0 misses; the 7 kernel libraries and the host "
              f"library from the tier in {b['build_s']:.2f} s (the main build "
              f"{built['build_s']:.1f} s), the process's wall {b['wall_s']:.1f} s; "
              f"each kernel once against its plain version: "
              + ", ".join(f"{k} {v:.3e}" for k, v in b["kernels"].items())
              + f"; a pinned sw_steps pair from_disk {b['pin']['from_disk']} "
              f"(graph {b['pin']['graph']})")
        out["b"] = b
        _part(parts, "b", t0, 16)

        with ThreadPoolExecutor(1) as pool:
            fd = pool.submit(aot_serving_step_twice, tdir)
            manifest = os.path.join(tdir, "serving.json")
            emit = _json_run(["-m", "mpi4jax_tpu_torch.aot", "warm", "--emit-manifest",
                              manifest, "--world", "1", "--model", "bench", "--json"],
                             env, 120)
            t_warm = time.perf_counter()
            warm = _json_run(["-m", "mpi4jax_tpu_torch.aot", "warm", manifest, "--json"],
                             env, 300)
            warm_s = time.perf_counter() - t_warm
            if warm["warmed"] != emit["programs"] or warm["failed"]:
                raise AssertionError(f"(c): warm {warm['warmed']} of {emit['programs']}, "
                                     f"failures {warm['failures']}")
            served = _json_run(["-c", AOT_SERVE, repr(time.time())], env, 300)
            equal = sum(served["streams"].get(str(rid)) == list(s)
                        for rid, s in base_streams.items())
            if (served["disk_cache"]["misses"] or served["failed"]
                    or served["completed"] != len(base_streams)
                    or equal != len(base_streams)):
                raise AssertionError(
                    f"(c): misses {served['disk_cache']['misses']}, completed "
                    f"{served['completed']}, failed {served['failed']}, {equal} of "
                    f"{len(base_streams)} streams equal phase 15's")
            print(f"phase 16 (c) warm --emit-manifest (bench preset, world 1): "
                  f"{emit['programs']} programs; warm: exit 0, {warm['warmed']} warmed "
                  f"in {warm_s:.1f} s; a new process serving the bench preset: disk "
                  f"cache {served['disk_cache']['hits']} hits, 0 misses, "
                  f"{served['aot']['disk_loads']} pins from disk; spawn to the first "
                  f"token {served['spawn_to_first_token_s']:.2f} s (the interpreter "
                  f"{served['interpreter_s']:.2f} s, imports "
                  f"{served['imports_s']:.2f} s, the first request's TTFT "
                  f"{served['first_ttft_ms']} ms with its programs' pins); "
                  f"{equal}/{len(base_streams)} streams equal phase 15's")
            out["c"] = {"programs": emit["programs"], "warm": warm, "warm_s": warm_s,
                        "served": {k: v for k, v in served.items() if k != "streams"},
                        "streams_equal": equal}
            _part(parts, "c", t0, 16)
            first, second = fd.result()
        if first["from_disk"] or not second["from_disk"] \
                or second["disk_cache"]["hits"] < 1 or second["disk_cache"]["misses"]:
            raise AssertionError(f"(d): {first}, {second}")
        print(f"phase 16 (d) models/aot_serving_step.py twice, one directory: first "
              f"from_disk {first['from_disk']} (pin {first['pin_wall_s']} s, "
              f"{first['per_call_us']} us a call), second from_disk "
              f"{second['from_disk']} with {second['disk_cache']['hits']} hits (pin "
              f"{second['pin_wall_s']} s, {second['per_call_us']} us a call)")
        out["d"] = [first, second]
        _part(parts, "d", t0, 16)
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = parts
    print(f"phase 16 (persistent tier): {out['seconds']:.1f} s")
    return out


def aot_main():
    """``python3 chip_smoke.py --aot``: phase 16 alone: the build through a
    fresh tier, phase 15 (b)'s continuous unroll-4 streams in this process,
    then (b)-(d); one JSON line."""
    import shutil
    import tempfile

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mpi4jax_tpu_torch.kernels import flash_attention as FA
    from mpi4jax_tpu_torch.kernels import sw_phase as KP
    from mpi4jax_tpu_torch.kernels import sw_steps as K
    from mpi4jax_tpu_torch.kernels import sw_wide as KW
    from mpi4jax_tpu_torch.models import serving as MS

    tier = tempfile.mkdtemp(prefix="mpx-tier-")
    try:
        _, _, built = tier_build(K, KP, KW, FA, tier)
        trace, _ = MS.make_trace(MS.make_config("bench"))
        _, base = MS.serve_streams(MS.make_config("bench", virtual_clock=True), trace,
                                   _one_rank_comm("cuda"), "continuous")
        out = aot_phase(K, tier, built, base)
    finally:
        shutil.rmtree(tier, ignore_errors=True)
    print(smi)
    print(json.dumps({"aot": out}, default=str))
    return 0


# ---------------------------------------------------------------------------
# phase 17: the collective verifier
# ---------------------------------------------------------------------------


def _virtual(shape, axes, dev):
    """A comm over a virtual grid of ``shape`` on ``dev``, this process its
    rank 0: no ``torch.distributed`` (the verifier's abstract runs)."""
    from mpi4jax_tpu_torch import Comm, ProcessGrid

    return Comm(axes, mesh=ProcessGrid(tuple(shape), tuple(axes), dev, rank=0))


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def verifier_programs(P, dev):
    """(a)'s programs: ``{name: (fn, args, comm)}``, each at its path's
    full width, one rank's templates as ``meta`` tensors."""
    from mpi4jax_tpu_torch import attention as TA
    from mpi4jax_tpu_torch.models import pipeline_parallel as PP
    from mpi4jax_tpu_torch.models import serving as MS
    from mpi4jax_tpu_torch.parallel import moe
    from mpi4jax_tpu_torch.parallel.pipeline import pipeline, split_microbatches
    from mpi4jax_tpu_torch.serving import model as SM

    progs = {}
    cfg = P.Config(nx=3600, ny=1800, nproc_y=2, nproc_x=2)
    grid = _virtual((2, 2), ("py", "px"), dev)
    state = P.State(*[_meta((cfg.ny_local, cfg.nx_local))] * 6)
    for mode in ("wide2", "pallas_halo"):
        first, multi = P.make_stepper(cfg, grid, fast=mode)
        progs[f"shallow_water_{mode}"] = (
            lambda s, first=first, multi=multi: multi(first(s), 2), (state,), grid)
    ring = _virtual((4,), ("i",), dev)
    q = _meta((ATTN_B, ATTN_T // 4, ATTN_H, ATTN_D))
    progs["ring_attention_f32"] = (
        lambda a, b, c: TA.ring_attention(a, b, c, comm=ring), (q, q, q), ring)
    c = MOE_WIDE
    w = moe.init_moe_params(c["d"], c["d_ff"], 4, rank=0, seed=c["seed"])
    progs["moe_layer"] = (
        lambda x, a, b, d, f=c["factor"]: moe.moe_layer(
            x, moe.MoEParams(a, b, d), comm=ring, capacity_factor=f)[0],
        (_meta((c["tokens"], c["d"])), *(_meta(p.shape) for p in w)), ring)
    c = PIPE_WIDE
    x0, ws = (torch.from_numpy(a) for a in PP.build_inputs(4, c["batch"], c["dim"]))
    _, wi = PP.stage_weights(ws, 4, 0)
    mbs = split_microbatches(x0, c["microbatches"])
    prog = pipeline(PP.substage, c["microbatches"], schedule="interleaved",
                    virtual=2, comm=ring)
    progs["pipeline_interleaved"] = (
        lambda m, p: prog.trace(m, p)[0], (_meta(mbs.shape), _meta(wi.shape)), ring)
    scfg = MS.make_config("bench")
    bucket = max(scfg.table().buckets)
    args = tuple(_meta(s, getattr(torch, d))
                 for s, d in scfg.program_args("decode", bucket, 4))
    progs[f"serving_decode_bench_b{bucket}"] = (SM.decode_step, args, ring)
    return progs


def verifier_analyze(P, dev):
    """(a): every program through ``analyze(ranks="all")``."""
    from mpi4jax_tpu_torch import analyze, clear_caches
    from mpi4jax_tpu_torch.kernels import _build

    out = {}
    before = _build.launch_totals()
    for name, (fn, args, comm) in verifier_programs(P, dev).items():
        clear_caches()
        t0 = time.perf_counter()
        rep = analyze(fn, *args, comm=comm, ranks="all")
        seconds = time.perf_counter() - t0
        errs = [f.code for f in rep.errors]
        codes = sorted({f.code for f in rep.findings})
        print(f"phase 17 (a) {name}: analyze(ranks='all') {seconds:.3f} s, "
              f"{len(rep.events)} collectives a rank, findings {codes}")
        if errs:
            raise AssertionError(f"phase 17 (a) {name}: {rep.render()}")
        out[name] = {"seconds": seconds, "events": len(rep.events),
                     "codes": codes}
    moved = {k: v for k, v in _build.launch_totals().items() if before.get(k) != v}
    if moved:
        raise AssertionError(f"phase 17 (a): the abstract runs moved {moved}")
    print("phase 17 (a): every kernel's launch counter unmoved")
    return out


def verifier_ambient(P, K, dev, smi):
    """(b): the main path under each ambient mode."""
    from mpi4jax_tpu_torch import clear_caches, set_analyze_mode
    from mpi4jax_tpu_torch.analysis import crossrank

    cfg = P.Config(nx=3600, ny=1800)
    t1 = 0.1 * P.DAY_IN_SECONDS
    out, finals = {}, {}
    try:
        for mode in ("off", "warn", "error"):
            set_analyze_mode(mode)
            clear_caches()
            K.counter.launches = 0
            sec, ver = crossrank.stats["seconds"], crossrank.stats["verifications"]
            info = {}
            wall, n_steps, final = P.solve_fused(cfg, t1, device=dev, fast="auto",
                                                 pinned=True, return_state=True,
                                                 info=info)
            finals[mode] = [f.cpu() for f in final]
            out[mode] = {"steps_per_s": n_steps / wall, "wall": wall,
                         "n_steps": n_steps, "launches": K.counter.launches,
                         "runs": info["runs"],
                         "verifications": crossrank.stats["verifications"] - ver,
                         "verify_s": crossrank.stats["seconds"] - sec}
            print(f"phase 17 (b) solve_fused pinned 3600x1800, ANALYZE={mode}: "
                  f"{n_steps} steps, {out[mode]['steps_per_s']:.2f} steps/s, "
                  f"sw_steps launches {out[mode]['launches']}, "
                  f"{out[mode]['verifications']} verification(s) in "
                  f"{out[mode]['verify_s'] * 1e3:.2f} ms ({smi})")
            del final
            torch.cuda.empty_cache()
    finally:
        set_analyze_mode(None)
    for mode in ("warn", "error"):
        if out[mode]["launches"] != out["off"]["launches"]:
            raise AssertionError(f"phase 17 (b) {mode}: launches {out[mode]}")
        if out[mode]["verifications"] < 1:
            raise AssertionError(f"phase 17 (b) {mode}: nothing was verified")
        for a, b in zip(finals[mode], finals["off"]):
            if not torch.equal(a, b) or a.numpy().tobytes() != b.numpy().tobytes():
                raise AssertionError(f"phase 17 (b) {mode}: the final state differs")
    if out["off"]["verifications"]:
        raise AssertionError("phase 17 (b): the verifier ran under off")
    print("phase 17 (b): final fields bit for bit and sw_steps launches equal "
          "under off, warn and error")
    return out


def verifier_cli():
    """(c): the command over each broken twin, four processes at once."""
    from mpi4jax_tpu_torch.models import broken

    env = dict(os.environ)
    env["PYTHONPATH"] = os.getcwd() + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("MPI4JAX_TPU_ANALYZE", None)
    t0 = time.perf_counter()
    procs = {}
    for name in broken.TWINS:
        path = os.path.join("mpi4jax_tpu_torch", "models", "broken", f"{name}.py")
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "mpi4jax_tpu_torch.analysis", "--ranks", "4",
             "--json", path], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        codes = sorted({c for r in json.loads(stdout)["reports"] for c in r["codes"]})
        twin = __import__(f"mpi4jax_tpu_torch.models.broken.{name}",
                          fromlist=["CODES"])
        if p.returncode != 1 or not twin.CODES & set(codes):
            raise AssertionError(f"phase 17 (c) {name}: exit {p.returncode}, codes "
                                 f"{codes}: {stderr[-2000:]}")
        out[name] = {"exit": p.returncode, "codes": codes}
        print(f"phase 17 (c) python -m mpi4jax_tpu_torch.analysis --ranks 4 "
              f"--json {name}.py: exit {p.returncode}, codes {codes}")
    out["seconds"] = time.perf_counter() - t0
    return out


def verifier_phase(P, K, dev, smi):
    """Phase 17 (see the module docstring); returns its summary, printed
    as one JSON line."""
    from mpi4jax_tpu_torch.models import broken

    t0 = time.perf_counter()
    out = {"card": smi}
    out["a"] = verifier_analyze(P, dev)
    torch.cuda.empty_cache()
    out["b"] = verifier_ambient(P, K, dev, smi)
    out["c"] = verifier_cli()
    t = time.perf_counter()
    d = broken.drill("rank_divergent_deadlock",
                     ["--launch", "4", "--device", "cuda:0", "--timeout", "60"])
    if d["launch"] != [["MPX121"]] * 4:
        raise AssertionError(f"phase 17 (d): {d}")
    out["d"] = dict(d, seconds=time.perf_counter() - t)
    print(f"phase 17 (d) rank_divergent_deadlock on four gloo ranks on this card, "
          f"MPI4JAX_TPU_ANALYZE=error: every rank raised AnalysisError {d['launch'][0]} "
          f"before any exchange in {out['d']['seconds']:.1f} s (limit 60 s)")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 17 (verifier): {out['seconds']:.1f} s; (c) "
          f"{out['c']['seconds']:.1f}, (d) {out['d']['seconds']:.1f}")
    return out


def verifier_main():
    """``python3 chip_smoke.py --verifier``: the stencil build, then phase
    17 alone; one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mpi4jax_tpu_torch.kernels import sw_steps as K
    from mpi4jax_tpu_torch.models import shallow_water as P

    K._library()
    out = verifier_phase(P, K, torch.device("cuda"), smi)
    print(smi)
    print(json.dumps({"verifier": out}, default=str))
    return 0


# ---------------------------------------------------------------------------
# phase 18: the cost model and the tuning layer
# ---------------------------------------------------------------------------

# phase 14 (c)'s shape: stages, microbatches, boundary bytes
PIPE_AUTO = (4, PIPE_WIDE["microbatches"],
             (PIPE_WIDE["batch"] // PIPE_WIDE["microbatches"]) * PIPE_WIDE["dim"] * 4)


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.getcwd() + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("MPI4JAX_TPU_ANALYZE", "MPI4JAX_TPU_TUNING", "MPI4JAX_TPU_COST_MODEL"):
        env.pop(k, None)
    return env


def cost_autotune(tdir):
    """(a): ``python -m mpi4jax_tpu_torch.autotune`` over four gloo ranks on
    this card (budget 30 s), and its rank function in this process as one
    CUDA rank (budget 20 s; the exit code the command would give); each
    file validated by the port's ``validate_tuning_dict``."""
    from mpi4jax_tpu_torch.autotune import validate_tuning_dict
    from mpi4jax_tpu_torch.autotune.runner import rank_autotune

    out = {}
    for label, budget in (("gloo4", 30), ("cuda1", 20)):
        path = os.path.join(tdir, f"tuning_{label}.json")
        t0 = time.perf_counter()
        if label == "gloo4":
            p = subprocess.run(
                [sys.executable, "-m", "mpi4jax_tpu_torch.autotune",
                 "--budget-s", str(budget), "--save", path, "--ranks", "4",
                 "--device", "cuda:0"], env=_child_env(),
                capture_output=True, text=True, timeout=600)
            rc, log = p.returncode, p.stderr
        else:
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                res = rank_autotune(0, budget, path, device="cuda:0")
            rc = 1 if res["unfitted"] else 0
            log = err.getvalue() + ("autotune: untuned knob(s): "
                                    + ", ".join(res["unfitted"]))
        seconds = time.perf_counter() - t0
        # 1: a partial fit, the file written (one host without a topology
        # to sweep leaves the alltoall crossover untuned)
        if rc not in (0, 1) or not os.path.exists(path):
            raise AssertionError(f"phase 18 (a) {label}: exit {rc}: "
                                 f"{log[-2000:]}")
        with open(path) as f:
            payload = json.load(f)
        validate_tuning_dict(payload)
        ici, tuned = payload["links"]["ici"], payload["tuned"]
        pack = tuned.get("commit", {}).get("pack_gb_per_s")
        untuned = [ln for ln in log.splitlines() if "untuned" in ln]
        print(f"phase 18 (a) autotune {label} (budget {budget} s): exit "
              f"{rc} in {seconds:.1f} s; ici alpha {ici['alpha_us']} us, "
              f"beta {ici['gb_per_s']} GB/s; gamma {payload['gamma_gb_per_s']} GB/s, "
              f"compute {payload['compute_gb_per_s']} GB/s, dispatch "
              f"{payload['dispatch_us']} us; pack {pack} GB/s; fusion bucket "
              f"{tuned.get('fusion_bucket_bytes')} B, overlap chunks "
              f"{tuned.get('overlap_chunks')}; {'; '.join(untuned) or 'all fitted'}")
        out[label] = {"path": path, "exit": rc, "seconds": seconds,
                      "payload": payload}
    print("phase 18 (a): both files validate under the port's validate_tuning_dict "
          "(this script imports nothing of the JAX package, so the JAX validator "
          "is held equal to it in the CPU tests instead)")
    return out


def cost_programs(P, dev):
    """(b)'s programs: phase 17 (a)'s on the virtual 4-rank grid, and the
    bench decode on a one-rank grid (the shape phase 15 measures)."""
    from mpi4jax_tpu_torch.models import serving as MS
    from mpi4jax_tpu_torch.serving import model as SM

    progs = verifier_programs(P, dev)
    one = _virtual((1,), ("i",), dev)
    scfg = MS.make_config("bench")
    bucket = max(scfg.table().buckets)
    args = tuple(_meta(s, getattr(torch, d))
                 for s, d in scfg.program_args("decode", bucket, 1))
    progs[f"serving_decode_bench_b{bucket}_1rank"] = (SM.decode_step, args, one)
    return progs


def cost_analyze(P, dev, tuning, measured):
    """(b): ``analyze(cost=True, ranks="all")`` under the four-rank file;
    ``measured``: {program: (measured us, what, predicted units)}."""
    from mpi4jax_tpu_torch import analyze, clear_caches
    from mpi4jax_tpu_torch.analysis import costmodel
    from mpi4jax_tpu_torch.kernels import _build

    model = costmodel.load_model(tuning)
    out = {}
    before = _build.launch_totals()
    for name, (fn, args, comm) in cost_programs(P, dev).items():
        clear_caches()
        t0 = time.perf_counter()
        rep = analyze(fn, *args, comm=comm, ranks="all", cost=True,
                      cost_model=model)
        seconds = time.perf_counter() - t0
        c = rep.cost
        if c is None or rep.errors:
            raise AssertionError(f"phase 18 (b) {name}: {rep.render()}")
        wire = sum(v["time_us"] for v in c.per_link.values())
        compute = max(c.compute_us.values()) if c.compute_us else 0.0
        adv = sorted({f.code for f in rep.findings})
        print(f"phase 18 (b) {name}: predicted {c.total_us:.1f} us (critical path "
              f"{c.path_us:.1f} + dispatch {c.dispatch_us:.1f}; compute up to "
              f"{compute:.1f} us a rank, wire {wire:.1f} us over its ops), 0 "
              f"errors, advisories {adv}, {seconds:.3f} s")
        row = {"total_us": c.total_us, "path_us": c.path_us, "compute_us": compute,
               "wire_us": wire, "advisories": adv, "seconds": seconds}
        if name in measured:
            got_us, what, units = measured[name]
            pred = c.total_us / units
            row.update(measured_us=got_us, predicted_us=pred, ratio=pred / got_us)
            print(f"  beside {what}: predicted {pred:.1f} us, measured {got_us:.1f} "
                  f"us, predicted/measured {pred / got_us:.3f}")
        out[name] = row
    moved = {k: v for k, v in _build.launch_totals().items() if before.get(k) != v}
    if moved:
        raise AssertionError(f"phase 18 (b): the abstract runs moved {moved}")
    print("phase 18 (b): every kernel's launch counter unmoved")
    return out


def cost_ambient(P, K, dev, smi, tuning):
    """(c): the pinned periodic solve with the file loaded, under ``off`` and
    under ``MPI4JAX_TPU_ANALYZE=error`` + ``MPI4JAX_TPU_ANALYZE_COST=on``."""
    from mpi4jax_tpu_torch import clear_caches, load_tuning
    from mpi4jax_tpu_torch.analysis import crossrank, hook

    cfg = P.Config(nx=3600, ny=1800)
    t1 = 0.1 * P.DAY_IN_SECONDS
    out, finals = {}, {}
    load_tuning(tuning)
    try:
        for label, env in (("off", {}), ("error+cost", {
                "MPI4JAX_TPU_ANALYZE": "error", "MPI4JAX_TPU_ANALYZE_COST": "on"})):
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            sink = []
            hook.set_report_sink(sink)
            try:
                clear_caches()
                K.counter.launches = 0
                ver = crossrank.stats["verifications"]
                info = {}
                wall, n_steps, final = P.solve_fused(
                    cfg, t1, device=dev, fast="auto", pinned=True,
                    return_state=True, info=info)
            finally:
                hook.set_report_sink(None)
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            finals[label] = [f.cpu() for f in final]
            costs = [r.cost.total_us for _, r in sink if r.cost is not None]
            out[label] = {"steps_per_s": n_steps / wall, "n_steps": n_steps,
                          "launches": K.counter.launches,
                          "verifications": crossrank.stats["verifications"] - ver,
                          "predicted_us": costs}
            print(f"phase 18 (c) solve_fused pinned 3600x1800, {label}, tuning "
                  f"loaded: {n_steps} steps, {out[label]['steps_per_s']:.2f} steps/s, "
                  f"sw_steps launches {out[label]['launches']}, "
                  f"{out[label]['verifications']} verification(s), predicted "
                  f"{[round(x, 1) for x in costs]} us per verified region ({smi})")
            del final
            torch.cuda.empty_cache()
    finally:
        load_tuning(None)
        clear_caches()
    a, b = out["off"], out["error+cost"]
    if b["launches"] != a["launches"] or b["verifications"] < 1 or a["verifications"]:
        raise AssertionError(f"phase 18 (c): {out}")
    for x, y in zip(finals["error+cost"], finals["off"]):
        if not torch.equal(x, y) or x.numpy().tobytes() != y.numpy().tobytes():
            raise AssertionError("phase 18 (c): the final state differs")
    print("phase 18 (c): final fields bit for bit and sw_steps launches equal under "
          "off and error + cost")
    return out


def cost_ef_drill(cli=None):
    """(d): ``ef_divergent_gate`` through the command (phase 17 (c)'s run when
    given, else all the twins now) and on four gloo ranks under ``error``."""
    from mpi4jax_tpu_torch.models import broken

    if cli is None:
        cli = verifier_cli()
    ef = cli["ef_divergent_gate"]
    if ef["exit"] != 1 or "MPX141" not in ef["codes"]:
        raise AssertionError(f"phase 18 (d): the command gave {ef}")
    earlier = {k: v["exit"] for k, v in cli.items()
               if k in broken.TWINS and k != "ef_divergent_gate"}
    if set(earlier.values()) != {1}:
        raise AssertionError(f"phase 18 (d): the earlier twins gave {earlier}")
    t = time.perf_counter()
    d = broken.drill("ef_divergent_gate",
                     ["--launch", "4", "--device", "cuda:0", "--timeout", "60"])
    if not all("MPX141" in codes for codes in d["launch"]):
        raise AssertionError(f"phase 18 (d): {d}")
    seconds = time.perf_counter() - t
    print(f"phase 18 (d) ef_divergent_gate: the command exits 1 with "
          f"{ef['codes']} (the four earlier twins exit {sorted(set(earlier.values()))}); "
          f"on four gloo ranks on this card under error every rank raised "
          f"{d['launch'][0]} before any exchange, {seconds:.1f} s with the "
          "virtual-grid front-ends")
    return {"cli": ef, "earlier": earlier, "drill": d, "seconds": seconds}


def cost_consumers(tuning, served=None):
    """(e): ``pipeline(schedule="auto")`` at phase 14 (c)'s shape against
    ``best_schedule`` under the file, and the serve twin's ``--simulate`` at
    the bench preset (beside phase 15's measured numbers when given)."""
    from mpi4jax_tpu_torch import load_tuning
    from mpi4jax_tpu_torch.analysis import costmodel
    from mpi4jax_tpu_torch.models import pipeline_parallel as PP
    from mpi4jax_tpu_torch.models import serving as MS
    from mpi4jax_tpu_torch.parallel.pipeline import pipeline

    stages, mb, nbytes = PIPE_AUTO
    out = {}
    load_tuning(tuning)
    try:
        model = costmodel.load_model()
        if model.tuned_stamp is None:
            raise AssertionError("phase 18 (e): the tuning layer feeds no model")
        plan = pipeline(PP.stage_pair, mb).plan(stages, mb, nbytes)
        best, times = costmodel.best_schedule(
            stages, mb, nbytes, model.compute_us(2 * nbytes), model, virtual=1)
        if plan.schedule != best:
            raise AssertionError(f"phase 18 (e): auto {plan.schedule}, best {best}")
        print(f"phase 18 (e) pipeline(schedule='auto') at {stages} stages x {mb} "
              f"microbatches, {nbytes // 1024} KiB boundaries, model "
              f"tuned@{model.tuned_stamp}: {plan.schedule}, best_schedule prices "
              + ", ".join(f"{k} {v:.1f} us" for k, v in sorted(times.items())))
        out["pipeline"] = {"auto": plan.schedule, "times_us": times}
        path = os.path.join(os.path.dirname(tuning), "simulate.json")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            rc = MS.main(["--model", "bench", "--simulate", "--json", "--out", path])
        with open(path) as f:
            sim = json.load(f)
    finally:
        load_tuning(None)
    if rc != 0:
        raise AssertionError(f"phase 18 (e): --simulate exit {rc}")
    cont = sim["continuous"]
    line = (f"phase 18 (e) models.serving --model bench --simulate: predicted "
            f"{cont['tokens_per_s_per_chip']} tokens/s/chip, p99 {cont['p99_ms']} ms")
    if served is not None:
        line += (f"; phase 15 measured {served['tokens_per_s_per_chip']} tokens/s/chip, "
                 f"p99 {served['p99_ms']} ms")
    print(line)
    out["simulate"] = {"continuous": cont, "static": sim.get("static"),
                       "measured": served}
    return out


def cost_phase(P, K, dev, smi, measured=None, cli=None, served=None):
    """Phase 18 (see the module docstring); returns its summary, printed as
    one JSON line."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    tdir = tempfile.mkdtemp(prefix="mpx-tuning-")
    try:
        out = {"card": smi}
        out["a"] = cost_autotune(tdir)
        tuning = out["a"]["gloo4"]["path"]
        out["b"] = cost_analyze(P, dev, tuning, measured or {})
        torch.cuda.empty_cache()
        out["c"] = cost_ambient(P, K, dev, smi, tuning)
        out["d"] = cost_ef_drill(cli)
        out["e"] = cost_consumers(tuning, served)
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 18 (cost): {out['seconds']:.1f} s; (a) "
          f"{out['a']['gloo4']['seconds']:.1f} + {out['a']['cuda1']['seconds']:.1f}, "
          f"(d) {out['d']['seconds']:.1f}")
    return out


def cost_main():
    """``python3 chip_smoke.py --cost``: the stencil build, then phase 18
    alone (nothing measured beside its predictions); one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mpi4jax_tpu_torch.kernels import sw_steps as K
    from mpi4jax_tpu_torch.models import shallow_water as P

    K._library()
    out = cost_phase(P, K, torch.device("cuda"), smi)
    print(smi)
    print(json.dumps({"cost": out}, default=str))
    return 0


# ---------------------------------------------------------------------------
# phase 19: the collective algorithm layer.  Four gloo ranks on this card
# under MPI4JAX_TPU_TOPOLOGY=2x2 (2 faked hosts x 2 ranks): the demo twin,
# every lowering's results against the same lowering on the CPU (digests
# of the bytes: bit for bit), the codec legs, the MoE layer with auto
# picking the hierarchical alltoall, and the new autotune sweeps.  No
# kernel of the table runs; four processes on one card with faked hosts,
# so no number here is a hierarchy's gain.
# ---------------------------------------------------------------------------

HIER_SPEC = "2x2"
# the (2,2) training cell's gradient bytes (PERF.md section 4): 33.6 MB
# f32, and 64 KiB below the ring crossover (1 MiB)
HIER_SIZES = {"grad": 33_554_432 // 4, "below": (1024 - 64) * 1024 // 4}
HIER_ALGOS = ("butterfly", "ring", "hier")
HIER_TUNE_BUDGET_S = 20


def _first_nonzero(a, b):
    return torch.where(a != 0, a, b)


def _digest(t):
    """dtype, shape and the sha256 of the bytes of ``t``."""
    a = t.detach().cpu().contiguous()
    raw = a.reshape(-1).view(torch.uint8).numpy().tobytes()
    return (str(a.dtype), tuple(a.shape), hashlib.sha256(raw).hexdigest())


def _hier_inputs(n, rank, dev, seed=19):
    g = torch.Generator().manual_seed(seed + rank)
    f = torch.randn(n, generator=g)
    f[torch.rand(n, generator=g) < 0.25] = 0.0
    i = torch.randint(-1 << 20, 1 << 20, (n,), generator=g, dtype=torch.int32)
    return f.to(dev), i.to(dev)


def hierarchy_cases(rank, device, timed):
    """(b) on one rank: every case under each forced lowering at both
    sizes; per case the digest, and with ``timed`` the ms (host wall, the
    card synchronised), the exchanges, the staged bytes and the counters'
    link columns and algorithm."""
    import mpi4jax_tpu_torch as tpx
    from mpi4jax_tpu_torch import telemetry
    from mpi4jax_tpu_torch.ops import _staging

    mesh = tpx.make_world_mesh(device=device)
    comm = tpx.Comm(mesh.axes[0], mesh=mesh)
    split = comm.Split([r % 2 for r in range(comm.Get_size())])
    dev, k = mesh.device, comm.Get_size()
    out = {}

    def run(key, fn):
        telemetry.set_telemetry_mode("counters")
        try:
            telemetry.reset()
            _staging.stats.reset()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            res = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) * 1e3
            rows = list(telemetry.snapshot()["ops"].values())
        finally:
            telemetry.set_telemetry_mode(None)
            telemetry.reset()
        rec = {"digest": _digest(res)}
        if timed:
            rec.update(ms=ms, rounds=_staging.stats.calls,
                       staged=_staging.stats.staged_bytes,
                       algo=sorted({r["algo"] for r in rows}),
                       intra=sum(r["intra_bytes"] for r in rows),
                       inter=sum(r["inter_bytes"] for r in rows),
                       wire_inter=sum(r["wire_inter_bytes"] for r in rows))
        out[key] = rec
        return res

    algo_env = os.environ.get("MPI4JAX_TPU_COLLECTIVE_ALGO")
    try:
        # warm every lowering once (plans, process groups, pinned buffers)
        for algo in HIER_ALGOS:
            os.environ["MPI4JAX_TPU_COLLECTIVE_ALGO"] = algo
            tpx.allreduce(torch.ones(64, device=dev), tpx.PROD, comm=comm)
            tpx.allreduce(torch.ones(64, device=dev), tpx.SUM, comm=split)
        for size, n in HIER_SIZES.items():
            f, i = _hier_inputs(n, rank, dev)
            blocks = f[: (n // k) * k].reshape(k, -1)
            for algo in HIER_ALGOS:
                os.environ["MPI4JAX_TPU_COLLECTIVE_ALGO"] = algo
                pre = f"{size}/{algo}/"
                run(pre + "allreduce/f/SUM",
                    lambda: tpx.allreduce(f, tpx.SUM, comm=comm)[0])
                run(pre + "allreduce/f/PROD",
                    lambda: tpx.allreduce(1.0 + f * 1e-3, tpx.PROD, comm=comm)[0])
                run(pre + "allreduce/f/MAX",
                    lambda: tpx.allreduce(f, tpx.MAX, comm=comm)[0])
                run(pre + "allreduce/i/BXOR",
                    lambda: tpx.allreduce(i, tpx.BXOR, comm=comm)[0])
                run(pre + "allreduce/f/first_nonzero",
                    lambda: tpx.allreduce(f, _first_nonzero, comm=comm)[0])
                run(pre + "split/allreduce/f/SUM",
                    lambda: tpx.allreduce(f, tpx.SUM, comm=split)[0])
                run(pre + "reduce_scatter/f/SUM",
                    lambda: tpx.reduce_scatter(blocks, tpx.SUM, comm=comm)[0])
                for root in (0, 3):
                    run(pre + f"bcast/{root}/f",
                        lambda: tpx.bcast(f, root, comm=comm)[0])
            if timed:
                # the native route under auto, beside the lowerings: one
                # dist.all_reduce (gloo's own fold, so timed, not compared)
                os.environ["MPI4JAX_TPU_COLLECTIVE_ALGO"] = "auto"
                run(f"{size}/native/allreduce/f/SUM",
                    lambda: tpx.allreduce(f, tpx.SUM, comm=comm)[0])
            del f, i, blocks
        # the codec legs: the hierarchical SUM under off, bf16 and fp8, at
        # the JAX suite's size (512 a rank) and at the gradient bytes; each
        # held to the CPU's bits, its error against the exact leg printed
        # (the CPU tests hold them against the JAX package's legs)
        os.environ["MPI4JAX_TPU_COLLECTIVE_ALGO"] = "hier"
        for size, n in (("band", 512), ("grad", HIER_SIZES["grad"])):
            f, _ = _hier_inputs(n, rank, dev, seed=3)
            exact = None
            for codec in ("off", "bf16", "fp8"):
                os.environ["MPI4JAX_TPU_COMPRESS"] = codec
                try:
                    got = run(f"codec/{size}/{codec}/allreduce/f/SUM",
                              lambda: tpx.allreduce(f, tpx.SUM, comm=comm)[0])
                finally:
                    os.environ.pop("MPI4JAX_TPU_COMPRESS", None)
                if exact is None:
                    exact = got.double()
                    continue
                scale = torch.clamp(exact.abs(), min=1.0)
                out[f"codec/{size}/{codec}/allreduce/f/SUM"]["rel_err"] = float(
                    ((got.double() - exact).abs() / scale).max())
    finally:
        if algo_env is None:
            os.environ.pop("MPI4JAX_TPU_COLLECTIVE_ALGO", None)
        else:
            os.environ["MPI4JAX_TPU_COLLECTIVE_ALGO"] = algo_env
    return out


def hierarchy_moe(rank, device):
    """(d) on one rank: the MoE layer at phase 14 (b)'s width under
    ``auto`` (the dispatch and combine above the alltoall crossover: the
    hierarchical alltoall) against the flat one (``butterfly`` forces
    flat): bit for bit, the ms a layer, and one layer's counters by link
    class."""
    import mpi4jax_tpu_torch as tpx
    from mpi4jax_tpu_torch import telemetry
    from mpi4jax_tpu_torch.parallel import moe

    mesh = tpx.make_world_mesh(device=device)
    comm = tpx.Comm(mesh.axes[0], mesh=mesh)
    dev, k = mesh.device, comm.Get_size()
    c = MOE_WIDE
    rng = np.random.default_rng(c["seed"])
    x = torch.from_numpy(rng.standard_normal(
        (k, c["tokens"], c["d"]), dtype=np.float32)[rank]).to(dev)
    params = moe.MoEParams(*(torch.from_numpy(a).to(dev) for a in
                             moe.init_moe_params(c["d"], c["d_ff"], k,
                                                 rank=rank, seed=c["seed"])))

    def layer():
        return tpx.spmd(lambda xv: moe.moe_layer(
            xv, params, comm=comm, chunks=2,
            capacity_factor=c["factor"])[0], comm=comm)(x)

    out = {}
    ys = {}
    for label, algo in (("auto", "auto"), ("flat", "butterfly")):
        os.environ["MPI4JAX_TPU_COLLECTIVE_ALGO"] = algo
        try:
            ys[label] = layer()
            out[f"{label}_ms"] = _wall_ms(dev, layer, 3)
            telemetry.set_telemetry_mode("counters")
            try:
                telemetry.reset()
                layer()
                rows = [r for r in telemetry.snapshot()["ops"].values()
                        if r["op"].startswith("alltoall")]
            finally:
                telemetry.set_telemetry_mode(None)
                telemetry.reset()
        finally:
            os.environ.pop("MPI4JAX_TPU_COLLECTIVE_ALGO", None)
        out[f"{label}_rows"] = [{key: r[key] for key in
                                 ("op", "algo", "calls", "bytes", "intra_bytes",
                                  "inter_bytes")} for r in rows]
    out["bitwise"] = bool(torch.equal(ys["auto"], ys["flat"]))
    out["finite"] = bool(torch.isfinite(ys["auto"]).all())
    return out


def hierarchy_rank(rank, device, timed=True):
    """Phase 19's parts (a), (b), (d), (e) on one rank of one launch under
    the faked topology; ``timed=False`` is the CPU reference run of (b)
    alone."""
    os.environ["MPI4JAX_TPU_TOPOLOGY"] = HIER_SPEC
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    if timed:
        from mpi4jax_tpu_torch import Comm, make_world_mesh
        from mpi4jax_tpu_torch.models import hierarchical_demo as HD
        from mpi4jax_tpu_torch.ops._hierarchy import hier_plan

        t = time.perf_counter()
        demo = HD.main(device)  # (a): raises where ring and hier disagree
        mesh = make_world_mesh(device=device)
        plan = hier_plan(Comm(mesh.axes[0], mesh=mesh))
        out["a"] = {"plan": demo["plan"], "plan_hr": (plan.h, plan.r),
                    "rows": demo["rows"], "seconds": time.perf_counter() - t}
    t = time.perf_counter()
    out["b"] = hierarchy_cases(rank, device, timed)
    out["b_seconds"] = time.perf_counter() - t
    if timed:
        torch.cuda.empty_cache()
        t = time.perf_counter()
        out["d"] = hierarchy_moe(rank, device)
        out["d"]["seconds"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        from mpi4jax_tpu_torch.autotune import autotune

        t = time.perf_counter()
        res = autotune(budget_s=HIER_TUNE_BUDGET_S, load=False,
                       topologies=(HIER_SPEC,), device=device)
        tuned = res.payload["tuned"]
        out["e"] = {"seconds": time.perf_counter() - t,
                    "fitted": list(res.fitted), "unfitted": list(res.unfitted),
                    "ring_crossover_bytes": tuned.get("ring_crossover_bytes"),
                    "alltoall_crossover_bytes": tuned.get(
                        "alltoall_crossover_bytes"),
                    "compress": tuned.get("compress"),
                    "topologies": res.payload.get("topologies"),
                    "sources": res.payload["provenance"]["fit_sources"]}
    return out


def hierarchy_phase(launch, smi):
    """Phase 19 (see the comment above); returns its summary, printed as
    one JSON line."""
    import threading

    t0 = time.perf_counter()
    cpu = {}

    def cpu_reference():
        cpu["ranks"] = launch.run(hierarchy_rank, 4, backend="gloo",
                                  device="cpu", timeout=300,
                                  args=("cpu", False))

    # (c)'s reference: the same lowerings on the CPU, beside the card's run
    th = threading.Thread(target=cpu_reference)
    th.start()
    ranks = launch.run(hierarchy_rank, 4, backend="gloo", device="cuda:0",
                       timeout=300, args=("cuda:0", True))
    th.join()
    if "ranks" not in cpu:
        raise AssertionError("phase 19 (c): the CPU reference run failed")
    a = ranks[0]["a"]
    if a["plan_hr"] != (2, 2):
        raise AssertionError(f"phase 19 (a): plan {a['plan_hr']}, expected (2, 2)")
    print(f"phase 19 (a) demo twin on four gloo ranks on this card: {a['plan']}")
    for row in a["rows"]:
        print(f"  telemetry: {row['op']} algo={row['algo']} intra_host="
              f"{row['intra_bytes']} B inter_host={row['inter_bytes']} B")
    # (c): every case bit for bit with the same lowering on the CPU, and
    # hier == ring == butterfly where the result does not depend on the
    # association
    bad, same = [], 0
    for r, (gpu, ref) in enumerate(zip(ranks, cpu["ranks"])):
        for key, rec in ref["b"].items():
            if gpu["b"][key]["digest"] != rec["digest"]:
                bad.append((r, key))
            else:
                same += 1
            algo = key.split("/")[1]
            if (key.split("/")[0] in HIER_SIZES and algo == "hier"
                    and gpu["b"][key]["algo"] != ["hier"]):
                raise AssertionError(f"phase 19 (b) rank {r}: {key} fell back "
                                     f"to {gpu['b'][key]['algo']}")
        for size in HIER_SIZES:
            for case in ("allreduce/f/MAX", "allreduce/i/BXOR",
                         "allreduce/f/first_nonzero", "bcast/0/f", "bcast/3/f"):
                ds = {gpu["b"][f"{size}/{algo}/{case}"]["digest"]
                      for algo in HIER_ALGOS}
                if len(ds) != 1:
                    bad.append((r, f"{size}/*/{case}: hier != flat"))
    if bad:
        raise AssertionError(f"phase 19 (c): {len(bad)} case(s) differ: {bad[:8]}")
    print(f"phase 19 (b)/(c) equivalence, {HIER_SPEC} faked: {same} results (4 "
          "ranks x every case) bit for bit with the same lowering on the CPU, f32 "
          "SUM and PROD and the bf16 and fp8 legs included (the native SUM is "
          "timed, not compared); MAX, BXOR, first-non-zero and both bcasts "
          "equal across butterfly, ring and hier")
    b0 = ranks[0]["b"]
    for key, rec in b0.items():
        if "ms" not in rec:
            continue
        print(f"  {key:<40} {rec['ms']:9.2f} ms, {rec['rounds']:2d} exchanges, "
              f"{rec['staged'] / 1e6:8.2f} MB staged; modeled intra "
              f"{rec['intra']} B, inter {rec['inter']} B, wire inter "
              f"{rec['wire_inter']} B" + (f"; rel err {rec['rel_err']:.2e}"
                                          if "rel_err" in rec else ""))
    d = [r["d"] for r in ranks]
    for r, rd in enumerate(d):
        if not (rd["bitwise"] and rd["finite"]):
            raise AssertionError(f"phase 19 (d) rank {r}: {rd}")
        if not any(row["algo"] == "hier" for row in rd["auto_rows"]):
            raise AssertionError(f"phase 19 (d) rank {r}: auto did not pick the "
                                 f"hierarchical alltoall: {rd['auto_rows']}")
    d0 = d[0]
    print(f"phase 19 (d) MoE layer at d {MOE_WIDE['d']}, d_ff {MOE_WIDE['d_ff']}, "
          f"{MOE_WIDE['tokens']} tokens a rank, chunks 2: auto (hier alltoall) "
          f"bit for bit with flat on 4/4 ranks; rank 0 ms a layer: auto "
          f"{d0['auto_ms']:.2f}, flat {d0['flat_ms']:.2f}")
    for label in ("auto", "flat"):
        for row in d0[f"{label}_rows"]:
            print(f"  {label}: {row['op']} algo={row['algo']} calls={row['calls']} "
                  f"intra_host={row['intra_bytes']} B inter_host="
                  f"{row['inter_bytes']} B")
    e = ranks[0]["e"]
    print(f"phase 19 (e) autotune over four gloo ranks (budget "
          f"{HIER_TUNE_BUDGET_S} s, --topologies {HIER_SPEC}): {e['seconds']:.1f} s; "
          f"ring crossover {e['ring_crossover_bytes']} B "
          f"({e['sources'].get('ring_crossover_bytes')}), alltoall crossover "
          f"{e['alltoall_crossover_bytes']} B, overrides {e['topologies']}, "
          f"codec {e['compress']}; untuned: {', '.join(e['unfitted']) or 'none'}")
    print(f"  {smi}: four processes on one card with faked hosts "
          f"(MPI4JAX_TPU_TOPOLOGY={HIER_SPEC}), exchanges staged through host "
          "memory: no number of phase 19 is a hierarchy's gain")
    out = {"a": a, "b": {"rank0": {key: {k: v for k, v in rec.items()
                                         if k != "digest"}
                                   for key, rec in b0.items()},
                         "bitwise_cases": same},
           "d": {"rank0": d0}, "e": e, "card": smi,
           "cpu_reference_seconds": cpu["ranks"][0]["b_seconds"],
           "seconds": time.perf_counter() - t0}
    print(f"phase 19 (hierarchy): {out['seconds']:.1f} s")
    return out


def hierarchy_main():
    """``python3 chip_smoke.py --hierarchy``: phase 19 alone (it launches no
    kernel, so nothing is built); one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    from mpi4jax_tpu_torch.parallel import launch

    out = hierarchy_phase(launch, smi)
    print(smi)
    print(json.dumps({"hierarchy": out}, default=str))
    return 0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    # every f32 product on the card in full f32, the plain versions' too
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from mpi4jax_tpu_torch import attention as TA
    from mpi4jax_tpu_torch.kernels import _build
    from mpi4jax_tpu_torch.kernels import flash_attention as FA
    from mpi4jax_tpu_torch.kernels import sw_phase as KP
    from mpi4jax_tpu_torch.kernels import sw_steps as K
    from mpi4jax_tpu_torch.kernels import sw_wide as KW
    from mpi4jax_tpu_torch.models import long_context_attention as LCA
    from mpi4jax_tpu_torch.models import long_context_training as LCT
    from mpi4jax_tpu_torch.models import shallow_water as P
    from mpi4jax_tpu_torch.models.shallow_water import DAY_IN_SECONDS, Config, State
    from mpi4jax_tpu_torch.parallel import launch

    # -- build: one nvcc per source, all at once, through a fresh tier ----
    import shutil
    import tempfile

    tier = tempfile.mkdtemp(prefix="mpx-tier-")
    libs, _, built = tier_build(K, KP, KW, FA, tier)
    print_stencil_ptxas(_build)
    print_flash_ptxas(_build.BUILD_DIR / "flash_fwd_tf32.build.log")
    fwd_tf32_hmma = sass_tf32_mma(libs[3], _build._nvcc())
    print_flash_ptxas(_build.BUILD_DIR / "flash_bwd_tf32.build.log")
    tf32_hmma = sass_tf32_mma(libs[4], _build._nvcc())
    print_flash_ptxas(_build.BUILD_DIR / "flash_bwd_mma.build.log")
    print_flash_ptxas(_build.BUILD_DIR / "flash_fwd_mma.build.log")

    dev = torch.device("cuda")
    names = State._fields

    # -- kernel against plain at full width -------------------------------
    geo = stencil_geometry(K, KW, KP, P)
    worst, per_case = check_steps_kernel(P, K, dev, names)
    phase_worst, phase_cases = check_phase_kernels(P, KP, dev, names)
    wide_worst, wide_cases = check_wide_kernel(P, KW, dev, names)

    # -- main path --------------------------------------------------------
    t1 = 0.1 * DAY_IN_SECONDS
    periodic = periodic_solve(P, K, dev, t1)
    launches, single_final = periodic["launches"], periodic.pop("final")
    worst20 = periodic["worst20"]
    walled = walled_solve(P, KW, dev, t1)
    wide_worst = max(wide_worst, walled["worst20"])
    wide_launches = walled["launches"]
    halo = halo_solve(P, KP, dev, t1)
    torch.cuda.empty_cache()

    # -- four ranks on this card: gloo, exchanges staged through the host --
    t0 = time.perf_counter()
    ranks = launch.run(shared_card_rank, 4, backend="gloo", device="cuda:0",
                       timeout=900, args=(t1, "cuda:0", 3600, 1800))
    print(f"four ranks (2,2), 3600x1800 periodic: {time.perf_counter() - t0:.1f} s "
          "with start-up")
    g = Config(nx=3600, ny=1800, nproc_y=2, nproc_x=2)
    run_worst = 0.0
    for k, fname in enumerate(names):
        stacked = torch.stack([torch.from_numpy(r["final"][k]) for r in ranks])
        got = torch.from_numpy(P.reassemble(stacked.numpy(), g))
        ref = single_final[k]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"four-rank final {fname} is not finite")
        err = (got - ref).abs().max().item()
        lim = RUN_BAND_ABS + RUN_BAND_REL * ref.abs().max().item()
        print(f"  four-rank wide2 vs single-GPU pallas2, final {fname}: "
              f"max|diff| {err:.3e} (band {lim:.3e})")
        if err > lim:
            raise AssertionError(f"four-rank final {fname} off by {err:.3e}")
        run_worst = max(run_worst, err)
    r0 = ranks[0]
    for r, res in enumerate(ranks):
        if res["wide_launches"] != 221 * res["runs"]:
            raise AssertionError(f"rank {r}: sw_wide launched {res['wide_launches']} "
                                 f"times, expected 221 x {res['runs']}")
        if res["phase_launches"] != 40:
            raise AssertionError(f"rank {r}: sw_phase launched "
                                 f"{res['phase_launches']} times, expected 40")
        if not res["halo_finite"] or res["halo_err"] > res["halo_band"]:
            raise AssertionError(f"rank {r}: pallas_halo off by {res['halo_err']:.3e}")
        print(f"  rank {r}: 20 steps pallas_halo vs fast max|diff| "
              f"{res['halo_err']:.3e} (band {res['halo_band']:.3e}); timed "
              f"solve {res['exchange_s']:.4f} s of {res['wall']:.4f} s inside "
              "exchanges")
    runs = r0["runs"]
    print(f"four processes share one card (gloo, exchanges staged through host "
          f"memory; not a scaling result): {r0['n_steps']} steps, wall "
          f"{r0['wall']:.4f} s, {r0['n_steps'] / r0['wall']:.2f} steps/s; rank 0 "
          f"per run: {r0['staged_bytes'] / runs / 1e6:.1f} MB staged, "
          f"{r0['exchange_calls'] // runs} exchanges; timed run: "
          f"{r0['exchange_s']:.4f} s of {r0['wall']:.4f} s inside exchanges "
          "(device work queued before each waited for first, waits for peers "
          "included)")
    print("NCCL not exercised: it needs one GPU per rank, and this machine has "
          f"{torch.cuda.device_count()}")
    torch.cuda.empty_cache()

    # -- long-context attention -------------------------------------------
    flash_worst, flash_cases = check_flash_kernels(FA, dev)
    torch.cuda.empty_cache()
    q, k, v = (torch.from_numpy(np.concatenate(list(x), axis=1)).to(dev)
               for x in LCA.demo_data(0, 4, ATTN_B, ATTN_T // 4, ATTN_H, ATTN_D))
    single, single_worst = single_gpu_attention(TA, FA, q, k, v)
    del q, k, v
    torch.cuda.empty_cache()
    ring_worst, attn_launches, attn_runs = four_rank_attention(LCA, launch, single,
                                                         "cuda:0")
    del single
    torch.cuda.empty_cache()

    # -- long-context training ---------------------------------------------
    bwd_worst, bwd_cases = check_flash_bwd_kernels(FA, dev)
    torch.cuda.empty_cache()
    print("backward digests (m from the plain forward; --bwd-digest prints them "
          "alone):", json.dumps({"sass": {lib.name: sass_digest(lib, _build._nvcc())
                                          for lib in libs[4:6]},
                                 "grads": backward_digests(FA, dev)}))
    torch.cuda.empty_cache()
    q, k, v = (torch.from_numpy(np.concatenate(list(x), axis=1)).to(dev)
               for x in LCA.demo_data(0, 4, ATTN_B, ATTN_T // 4, ATTN_H, ATTN_D))
    grad_worst, grad_runs = single_gpu_attention_grads(TA, FA, q, k, v)
    del q, k, v
    torch.cuda.empty_cache()
    train1 = single_gpu_training(LCT, TA, dev)
    torch.cuda.empty_cache()
    train4 = four_rank_training(LCT, launch, train1, "cuda:0")
    ring_grad_worst, ring_grad_launches, ring_grad_runs = four_rank_grads(launch,
                                                                          "cuda:0")
    torch.cuda.empty_cache()

    # -- bf16 attention: the tensor-core forward and backward kernels -----
    q, k, v = (torch.from_numpy(np.concatenate(list(x), axis=1)).to(dev)
               for x in LCA.demo_data(0, 4, ATTN_B, ATTN_T // 4, ATTN_H, ATTN_D))
    bf16_fwd_worst, bf16_fwd_launches, bf16_fwd_runs = bf16_attention_forward(
        TA, FA, q, k, v)
    bf16_worst, bf16_launches, bf16_runs = bf16_attention_grads(TA, FA, q, k, v)
    del q, k, v
    torch.cuda.empty_cache()

    # -- the op surface, the op-by-op ring backward and the dry run -------
    plain_worst, plain_launches, dry_kernels, plain_runs, surface = four_rank_surface(
        launch, "cuda:0", ring_grad_runs)
    torch.cuda.empty_cache()

    # -- data-parallel training and the throughput layer ------------------
    throughput = four_rank_throughput(
        launch, "cuda:0", {**TRAIN, "b_loc": ATTN_B // 2, "t_loc": ATTN_T // 2})
    torch.cuda.empty_cache()

    # -- the dispatch layer: megastep graphs, pins, staleness --------------
    dispatch = dispatch_phase(P, dev)
    print(json.dumps({"dispatch": dispatch}))

    # -- the runtime services: telemetry tiers, resilience drills ----------
    runtime = runtime_phase(P, dev, launch)
    print(json.dumps({"runtime": runtime}))
    one_gpu = runtime["one_gpu"]
    four = runtime["four_ranks"]["rank0"]

    # -- the health plane: ring, detector, bundles, profile_ops -------------
    health = health_phase(P, dev, launch)
    print(json.dumps({"health": health}))

    # -- elastic shrink-and-resume: no kernel, four gloo ranks -------------
    elastic = elastic_phase(dev, launch)
    print(json.dumps({"elastic": elastic}, default=str))

    # -- the parallel workloads: MoE and the pipeline, no kernel -----------
    workloads = workloads_phase(dev, launch, smi)
    print(json.dumps({"workloads": workloads}, default=str))

    # -- the serving runtime: one GPU, streams, the drain drill; no kernel --
    serving = serving_phase(dev, smi)
    base_streams = serving["b"].pop("streams")
    print(json.dumps({"serving": serving}, default=str))

    # -- the persistent tier: the libraries of the build, reloaded ---------
    try:
        aot = aot_phase(K, tier, built, base_streams)
    finally:
        shutil.rmtree(tier, ignore_errors=True)
    print(json.dumps({"aot": aot}, default=str))

    # -- the collective verifier: abstract runs, the ambient mode, the CLI --
    verifier = verifier_phase(P, K, dev, smi)
    print(json.dumps({"verifier": verifier}, default=str))

    # -- the cost model and the tuning layer: predictions beside this run --
    srv = serving["a"]
    measured = {
        "shallow_water_wide2": (
            r0["wall"] / r0["n_steps"] * 1e6,
            "the four-rank (2,2) wide2 solve above, rank 0's wall a step", 3),
        "moe_layer": (
            workloads["b"]["rank0"]["ms"]["chunks2"] * 1e3,
            "phase 14 (b)'s layer at chunks 2 (the default), rank 0", 1),
        "pipeline_interleaved": (
            workloads["c"]["rank3"]["ms"]["interleaved"] * 1e3,
            "phase 14 (c)'s interleaved round, rank 3", 1),
        f"serving_decode_bench_b{max(srv['program_ms'])}_1rank": (
            srv["program_ms"][max(srv["program_ms"])]["decode_megastep_ms"] * 1e3
            / srv["config"]["unroll"],
            "phase 15's decode megastep at its largest bucket, a token", 1),
    }
    cost = cost_phase(P, K, dev, smi, measured=measured, cli=verifier["c"],
                      served=srv["payload"]["continuous"])
    print(json.dumps({"cost": cost}, default=str))

    # -- the collective algorithm layer: faked hosts, four gloo ranks ------
    hierarchy = hierarchy_phase(launch, smi)
    print(json.dumps({"hierarchy": hierarchy}, default=str))

    pair = per_case["first=False,nsteps=2"]
    phase = phase_cases["periodic,phase1"]
    phase2 = phase_cases["periodic,phase2"]
    wide = wide_cases["nsteps=2"]
    kernels = [{
        "name": "sw_steps",
        "route": "cuda",
        "source": "mpi4jax_tpu_torch/csrc/sw_steps.cu",
        "replaces": "examples/shallow_water.py:799",
        "launches": launches,
        # phase 18 (c): the pinned solve under off and error + cost
        "cost_phase_launches": {k: v["launches"] for k, v in cost["c"].items()},
        "max_abs_err": max(worst, worst20),
        "ms": pair["ms"],
        "plain_ms": pair["plain_ms"],
        "bound_ms": pair["bound_ms"],
        "bound_by": pair["bound_by"],
        "library_ms": None,
        "ok": True,
        "by_case": per_case,
        "geometry": {k: g for k, g in geo.items() if k.startswith("sw_steps")},
        "periodic_solve_steps_per_s": periodic["steps_per_s"],
        "pair_ms_on_final_state": periodic["final_pair_ms"],
        # phase 10: the periodic megastep solves, one AB-2 step a launch
        "one_step": per_case["first=False,nsteps=1"],
        "dispatch_launches": {n: r["launches"] for n, r in dispatch["periodic"].items()
                              if n.startswith("unroll")},
        # phase 11: the periodic solve under each telemetry tier, every run
        "runtime_launches": {m: r["launches"] for m, r in one_gpu["periodic"].items()},
        # phase 12: one unroll=20 megastep replay under profile_ops
        "health_profile_launches": health["profiles"]["megastep"]["launches"],
    }, {
        "name": "sw_phase",
        "route": "cuda",
        "source": "mpi4jax_tpu_torch/csrc/sw_phase.cu",
        "replaces": "examples/shallow_water.py:1014",
        # the one-GPU split-phase solve, every run of it; ms and bounds are
        # phase 1's, phase 2's beside them
        "launches": halo["launches"],
        "max_abs_err": max(phase_worst, halo["max_abs_err"],
                           max(r["halo_err"] for r in ranks)),
        "ms": phase["ms"],
        "plain_ms": phase["plain_ms"],
        "bound_ms": phase["bound_ms"],
        "bound_by": phase["bound_by"],
        "library_ms": None,
        "ok": True,
        "phase2": phase2,
        "by_case": phase_cases,
        "geometry": {k: g for k, g in geo.items() if k.startswith("sw_phase")},
        "halo_solve": halo,
        "four_rank_launches_rank0": r0["phase_launches"],
        # phase 8: the dry run's split-phase shallow water, over its four
        # ranks, and its kernel-against-plain checks at those frames
        "dryrun_launches": dry_kernels["sw_phase"]["launches"],
        "dryrun_max_abs_err": dry_kernels["sw_phase"]["max_abs_err"],
        # phase 10: the split-phase megastep solve
        "dispatch_launches": {n: r["launches"] for n, r in dispatch["split_phase"].items()
                              if n.startswith("unroll")},
        # phase 11: the split-phase solve under each tier (one GPU), and
        # rank 0's 20 steps under each interleaved tier (four ranks)
        "runtime_launches": {m: r["launches"] for m, r in one_gpu["split_phase"].items()},
        "runtime_four_rank_launches_rank0": [r["phase_launches"] for r in four],
        # phase 12: the split-phase solve under counters (health off, on, on,
        # off) and events (off, on), every run; rank 0's 20 steps of each
        # four-rank run; one eager step under profile_ops
        "health_launches": {k: r["launches"] for k, r in health["one_gpu"].items()},
        "health_four_rank_launches_rank0": [r["launches_rank0"]
                                            for r in health["four_ranks"]],
        "health_profile_launches": health["profiles"]["eager_step"]["launches"],
    }, {
        "name": "sw_wide",
        "route": "cuda",
        "source": "mpi4jax_tpu_torch/csrc/sw_wide.cu",
        "replaces": "examples/shallow_water.py:1259",
        "launches": wide_launches,
        "max_abs_err": max(wide_worst, run_worst),
        "ms": wide["ms"],
        "plain_ms": wide["plain_ms"],
        "bound_ms": wide["bound_ms"],
        "bound_by": wide["bound_by"],
        "library_ms": None,
        "ok": True,
        "by_case": wide_cases,
        "geometry": {k: g for k, g in geo.items() if k.startswith("sw_wide")},
        "walled_solve_steps_per_s": walled["steps_per_s"],
        "four_rank_launches_rank0": r0["wide_launches"],
        # phase 8: the dry run's wide-halo shallow water (see sw_phase)
        "dryrun_launches": dry_kernels["sw_wide"]["launches"],
        "dryrun_max_abs_err": dry_kernels["sw_wide"]["max_abs_err"],
        # phase 10: the walled megastep solves, one step a launch
        "one_step": wide_cases["nsteps=1"],
        "dispatch_launches": {n: r["launches"] for n, r in dispatch["walled"].items()
                              if n.startswith("unroll")},
        # phase 11: rank 0's wide2 solve under each interleaved tier
        "runtime_four_rank_launches_rank0": [r["wide_launches"] for r in four],
    }]
    for name, main_case, replaces in (
        ("flash_fwd_tf32", "f32", ":122"),
        ("flash_fwd_causal_tf32", "f32,causal", ":166"),
    ):
        case = flash_cases[name][main_case]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "mpi4jax_tpu_torch/csrc/flash_fwd_tf32.cu",
            "replaces": "mpi4jax_tpu/kernels/flash_attention.py" + replaces,
            "launches": attn_launches[name],
            "max_abs_err": max(flash_worst[name], single_worst, ring_worst, plain_worst,
                               dry_kernels[name]["max_abs_err"]),
            "ms": case["ms"],
            "plain_ms": case["plain_ms"],
            # 3xTF32 on the tensor cores: 3 x the f32 operations at 494.7
            # TFLOP/s; the CUDA cores' f32 bound beside it
            "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"],
            "f32_cuda_core_bound_ms": case["f32_cuda_core_bound_ms"],
            "library_ms": case["library_ms"],
            "library": f"scaled_dot_product_attention ({case['library']})",
            "ok": True,
            "sass_hmma_tf32_in_library": fwd_tf32_hmma,
            "by_case": flash_cases[name],
            "four_rank_runs": attn_runs,
            # phase 8: ring_attention(memory_efficient_grad=False) forward and
            # backward on four ranks, causal and not, all ranks' launches
            "four_rank_op_by_op_launches": plain_launches[name],
            "four_rank_op_by_op_max_abs_err": plain_worst,
            # phase 8: the dry run's causal ring, over its four ranks
            "dryrun_launches": dry_kernels[name]["launches"],
            "dryrun_max_abs_err": dry_kernels[name]["max_abs_err"],
            # phase 9: the (2,2) training under each fusion mode
            "four_rank_fusion_training_launches_per_step": {
                mode: [ln[name] for ln in run["launches_per_step"]]
                for mode, run in throughput["lct"].items()},
        })
    for name, replaces in (("flash_bwd_dq_tf32", ":328"), ("flash_bwd_dkv_tf32", ":366")):
        case = bwd_cases[name]["f32"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "mpi4jax_tpu_torch/csrc/flash_bwd_tf32.cu",
            "replaces": "mpi4jax_tpu/kernels/flash_attention.py" + replaces,
            # five steps of single-GPU training, the slice's main path
            "launches": 5 * train1["launches_per_step"][name],
            "max_abs_err": max(bwd_worst[name], grad_worst, ring_grad_worst, plain_worst,
                               dry_kernels[name]["max_abs_err"]),
            "ms": case["ms"],
            "plain_ms": case["plain_ms"],
            # 3xTF32 on the tensor cores: 3 x the f32 operations at 494.7
            # TFLOP/s; the CUDA cores' f32 bound beside it
            "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"],
            "f32_cuda_core_bound_ms": case["f32_cuda_core_bound_ms"],
            "library_ms": case["library_ms"],
            "library": (f"scaled_dot_product_attention backward ({case['library']}), "
                        "dq, dk and dv in one call: set against dq + dk/dv"),
            "ok": True,
            "sass_hmma_tf32_in_library": tf32_hmma,
            "by_case": bwd_cases[name],
            "four_rank_grad_launches": ring_grad_launches[name],
            "four_rank_training_launches_per_step": [
                ln[name] for ln in train4["launches_per_step"]],
            # phase 9: the same (2,2) training under each fusion mode
            "four_rank_fusion_training_launches_per_step": {
                mode: [ln[name] for ln in run["launches_per_step"]]
                for mode, run in throughput["lct"].items()},
            "four_rank_op_by_op_launches": plain_launches[name],
            "four_rank_op_by_op_max_abs_err": plain_worst,
            # phase 8: the dry run's causal ring, over its four ranks
            "dryrun_launches": dry_kernels[name]["launches"],
            "dryrun_max_abs_err": dry_kernels[name]["max_abs_err"],
        })
    kernels[-1]["paths"] = {
        "attention_grads_1gpu": grad_runs,
        "training_1gpu": {k: v for k, v in train1.items() if k != "grads0"},
        "training_4ranks": train4, "attention_grads_4ranks": ring_grad_runs,
        "op_by_op_ring_grads_4ranks": plain_runs, "op_surface_4ranks": surface,
        "throughput_4ranks": throughput}
    for name, replaces in (("flash_bwd_dq_mma", ":328"), ("flash_bwd_dkv_mma", ":366")):
        case = bwd_cases[name]["bf16"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "mpi4jax_tpu_torch/csrc/flash_bwd_mma.cu",
            "replaces": "mpi4jax_tpu/kernels/flash_attention.py" + replaces,
            # bf16 flash_attention forward + backward, causal and not
            "launches": bf16_launches[name],
            "max_abs_err": bwd_worst[name],
            "ms": case["ms"],
            "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"],
            "library_ms": case["library_ms"],
            "library": (f"scaled_dot_product_attention backward ({case['library']}), "
                        "dq, dk and dv in one call: set against dq + dk/dv"),
            "ok": True,
            "by_case": bwd_cases[name],
        })
    kernels[-1]["paths"] = {"bf16_attention_grads_1gpu": bf16_runs,
                            "bf16_grads_max_abs_err_vs_f32_reference": bf16_worst}
    for name, main_case, replaces in (
        ("flash_fwd_mma", "bf16", ":122"),
        ("flash_fwd_causal_mma", "bf16,causal", ":166"),
    ):
        case = flash_cases[name][main_case]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "mpi4jax_tpu_torch/csrc/flash_fwd_mma.cu",
            "replaces": "mpi4jax_tpu/kernels/flash_attention.py" + replaces,
            # bf16 flash_attention forward alone, then forward + backward,
            # causal and not
            "launches": bf16_fwd_launches[name] + bf16_launches[name],
            "max_abs_err": flash_worst[name],
            "ms": case["ms"],
            "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"],
            "library_ms": case["library_ms"],
            "library": f"scaled_dot_product_attention ({case['library']})",
            "ok": True,
            "by_case": flash_cases[name],
        })
    kernels[-1]["paths"] = {"bf16_attention_forward_1gpu": bf16_fwd_runs,
                            "bf16_forward_max_abs_err_vs_f32_reference": bf16_fwd_worst}
    for entry in kernels:
        # phase 16 (b): the library reloaded from the tier in a fresh process
        entry["tier_reloaded_max_abs_err"] = aot["b"]["kernels"][entry["name"]]
    print(smi)  # again, so that the tail of a long log holds it too
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    modes = {"--bwd-digest": bwd_digest_main, "--stencils": stencils_main,
             "--ring": ring_main, "--dispatch": dispatch_main,
             "--runtime": runtime_main, "--health": health_main,
             "--elastic": elastic_main, "--workloads": workloads_main,
             "--serving": serving_main, "--aot": aot_main,
             "--verifier": verifier_main, "--cost": cost_main,
             "--hierarchy": hierarchy_main}
    sys.exit(modes[sys.argv[1]]() if sys.argv[1:] and sys.argv[1] in modes else main())
