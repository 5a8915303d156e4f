"""Dense-family model zoo in PyTorch, with the JAX package's layouts."""
