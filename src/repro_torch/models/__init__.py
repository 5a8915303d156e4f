"""Model zoo in PyTorch (the dense Llama family and the Mamba2 SSM family),
with the JAX package's layouts."""
