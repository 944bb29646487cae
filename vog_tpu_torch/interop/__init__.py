"""Weight conversion from the JAX package's flax param tree."""
