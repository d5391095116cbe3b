"""Kernels written by hand for Hopper, each beside its plain PyTorch version."""
