"""PyTorch + CUDA port of ``distributed_tensorflow_example_tpu``.

The JAX package beside this one is the reference: every module here
keeps its counterpart's name, its parameter names and layouts, and its
mixed-precision rounding points, so the same numpy inputs give the
same answers on both sides (``tests/test_torch_*.py`` hold the port to
that).  Inside, the idiom is PyTorch: plain functions on tensors, an
explicit ``device`` everywhere, ``torch.Generator`` for randomness.

This package imports ``torch`` and never ``jax``, and nothing of the
JAX package: where it needs one of that package's pure-Python modules
(the serving scheduler, admission, faults, the request spans, SLOs and
waterfalls of ``obs/``, the MNIST pipeline, the TensorBoard writer) it
carries its own copy.

Every TPU (Pallas) kernel on a ported path is a CUDA C++ kernel for
Hopper (``sm_90a``) under ``ops/csrc/``, built with ``nvcc`` at first
use and bound through ``ctypes`` (``ops/_build.py``).  Each wrapper
in ``ops/fused.py`` runs its plain PyTorch version for CPU tensors
only; for a CUDA tensor it launches the kernel or raises.

Ported so far: the serving path (``serving/cli.py`` -> ``serving/
engine.DecodeEngine`` -> prefill + paged decode, int8 or
compute-dtype pools, dense or MoE FFNs, request spans, SLOs and
waterfalls) with the fused LayerNorm, LayerNorm+residual and
grouped-FFN kernels, and the
one-card MLP and transformer trainers (``main.py`` -> ``train/
loop.run``: by default the device-resident epoch of ``parallel/
epoch.py``, the MLP's step replayed as a CUDA graph) with the fused MLP
forward, flash attention, LayerNorm backward and grouped-FFN training
kernels.  ROADMAP.md queues the rest.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
