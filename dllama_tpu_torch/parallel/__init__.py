"""Multi-device execution (the port of the JAX package's ``parallel/``):
the sequence-parallel ``sp`` axis so far."""
