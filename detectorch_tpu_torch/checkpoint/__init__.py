"""Parameter conversion between the JAX package's layout and the port's."""
