"""Ray tiling and conversion of scene state from the JAX package."""
