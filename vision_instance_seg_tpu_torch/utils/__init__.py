"""Weight conversion between the JAX package and the port."""
