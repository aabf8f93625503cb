"""Plain PyTorch references of the benchmark's methods. Nothing here
imports the program, ``jax`` or the JAX package."""
