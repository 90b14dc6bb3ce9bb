"""Serving package of the port: the paged KV cache, the continuous-
batching ``DecodeEngine`` and the ``/generate`` front door
(``serving.cli``).  The scheduler, admission and faults modules are
pure Python; nothing here builds a kernel at import."""
