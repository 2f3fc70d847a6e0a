"""Model configurations of the port (plain data: the JAX package's
``configs`` modules import JAX, so the port keeps its own copies)."""
