"""TensorBoard event files (``summary``) and ``.npz`` checkpoints in the
JAX package's layout (``checkpoint``)."""
