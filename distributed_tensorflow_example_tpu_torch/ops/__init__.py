"""Ops of the port: losses and metrics, fp8 rounding, paged-cache
primitives, plain, ring and Ulysses attention, and the wrappers of the hand-written CUDA
kernels (``fused``, ``flash_attention``; sources under ``csrc/``, built
by ``_build``).  Importing the package imports the two wrapper modules,
which registers every kernel's launch count (``_counts``); it builds
nothing."""

from . import fused, flash_attention  # noqa: F401  (register the counts)
