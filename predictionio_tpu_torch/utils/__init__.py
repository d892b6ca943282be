"""Host utilities of the port (trimmed copies of the JAX package's)."""
