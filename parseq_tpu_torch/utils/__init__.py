"""Weight conversion from the JAX package and the model registry."""
