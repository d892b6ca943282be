"""Sweep scheduling of the port (the JAX package's ``parallel``; its mesh,
collectives and distributed modules wait for sharded ALS)."""
