"""PyTorch/CUDA port of the model zoo's serving path for an NVIDIA H100.

The JAX package ``repro`` stays the reference; this package imports neither
JAX nor anything of ``repro``.  Entry points run on the card unless the caller
passes ``device="cpu"`` (see :mod:`repro_torch.device`).
"""
