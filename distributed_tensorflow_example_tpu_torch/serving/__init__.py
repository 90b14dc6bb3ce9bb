"""Serving package of the port: the paged KV cache, the continuous-
batching ``DecodeEngine``, the fleet router with its health scores and
circuit breakers (``router``, ``health``) and the ``dtx-serve`` front
door (``serving.cli``).  The scheduler, admission, faults, health and
router modules are pure Python; nothing here builds a kernel at
import."""
