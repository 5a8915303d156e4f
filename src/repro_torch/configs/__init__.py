"""Copies of the JAX package's configuration dataclasses and Llama configs."""
