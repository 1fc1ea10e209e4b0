"""Configuration dataclasses (copies of the JAX package's)."""
