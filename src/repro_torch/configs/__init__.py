"""Copies of the JAX package's configuration dataclasses and of the Llama
and mamba2-370m configs."""
