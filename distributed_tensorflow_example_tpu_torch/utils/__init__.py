"""TensorBoard event files (``summary``), ``.npz`` checkpoints in the
JAX package's layout (``checkpoint``) and the port's copy of the
``jax.random`` functions the fast path shuffles with (``prng``)."""
