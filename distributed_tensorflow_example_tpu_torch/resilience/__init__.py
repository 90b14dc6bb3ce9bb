"""The port's copy of the JAX package's resilience modules, so far the
restart policy, supervisor and restart narrator (``restart``).  Pure
Python: no torch, and nothing of the JAX package."""
