"""Ops of the port: losses and metrics, fp8 rounding, paged-cache
primitives, plain attention, and the wrappers of the hand-written CUDA
kernels (``fused``; sources under ``csrc/``, built by ``_build``).
Imported as submodules; importing them builds nothing."""
