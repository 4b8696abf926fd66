"""Data parallelism of the port (JAX package ``parallel/``)."""
