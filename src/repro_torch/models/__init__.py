"""Model zoo in PyTorch (the dense and MoE families, the Mamba2 SSM family
and the Zamba2 hybrid), with the JAX package's layouts."""
