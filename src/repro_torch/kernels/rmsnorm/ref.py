"""Plain PyTorch version of the fused RMSNorm (K2): the CPU path and the
card's reference."""
from __future__ import annotations

import torch

# How far the kernel may be from the plain version computed in f32 on the
# same inputs, per element, relative to that element: the kernel works in
# f32 and rounds once on output (at most 2^-8 |y| in bf16); a margin of 2.
RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -16}


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
                offset: float = 0.0) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (offset + w.float())).to(x.dtype)


def kernel_error(out: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                 eps: float = 1e-5, offset: float = 0.0) -> tuple[float, float]:
    """Hold a kernel's output against the plain version in f32 on the same
    inputs.  Returns the max abs error and the largest element error in
    units of its tolerance (RTOL): the kernel agrees when that is at most
    1."""
    ref = rmsnorm_ref(x.float(), w.float(), eps, offset)
    err = (out.float() - ref).abs()
    ratio = err / (RTOL[x.dtype] * ref.abs()).clamp_min(1e-30)
    return err.max().item(), ratio.max().item()
