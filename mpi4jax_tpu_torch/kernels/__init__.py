"""Kernels written by hand for Hopper, each beside its plain PyTorch version."""

from .flash_attention import flash_block_partials  # noqa: F401
