"""Plain PyTorch versions of the fused RMSNorm (K2) and of its backward
(K2b): the CPU path and the card's reference."""
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


def rmsnorm_bwd_ref(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-5, offset: float = 0.0,
                    dtype=torch.float32):
    """The gradients (dx, dw) of ``rmsnorm_ref`` as K2b computes them, in
    ``dtype``, each returned in its input's dtype: with x^ = x rstd and
    g = dy (offset + w), dx = rstd (g - x^ mean(g x^)) and dw = the sum of
    dy x^ over all leading dims."""
    dx, dw, _ = _bwd(x, w, dy, eps, offset, dtype)
    return dx.to(x.dtype), dw.to(w.dtype)


def _bwd(x, w, dy, eps, offset, dtype):
    """(dx, dw) in ``dtype`` and the sums of the magnitudes of their terms."""
    xf, gf = x.to(dtype), dy.to(dtype)
    wf = offset + w.to(dtype)
    rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xh = xf * rstd
    g = gf * wf
    c = (g * xh).mean(dim=-1, keepdim=True)
    dx = rstd * (g - xh * c)
    lead = tuple(range(x.dim() - 1))
    dw = (gf * xh).sum(dim=lead)
    terms = (rstd * (g.abs() + xh.abs() * (g * xh).abs().mean(
        dim=-1, keepdim=True)), (gf * xh).abs().sum(dim=lead))
    return dx, dw, terms


# How far K2b's gradients may be from the plain backward, computed in double
# on the same inputs.  dx: the kernel works in f32 and rounds once on output,
# 2^-8 of dx in bf16.  Its f32 row sums of d terms (mean x^2 and mean g x)
# are within d 2^-24 of exact (2^-13 at d = 2048), and about sqrt(d) 2^-24
# as their errors add as a random walk, which moves every dx of the row
# alike.  It is held per element within BWD_RTOL of its magnitude plus its
# terms' (rstd (|g| + |x^| mean|g x^|), which covers a cancelling g - x^ c):
# 2^-7 in bf16, a margin of 2; 2^-14 in f32.  dw:
# an f32 sum over the rows (8192 at a llama3-1b step) in another order
# differs by up to n 2^-24 of the terms' magnitudes, though the rounding
# errors add as a random walk (about 2^-17); it is then rounded to w's dtype
# (2^-8 in bf16).  Held within DW_RTOL of |dw| plus its terms' magnitudes.
# Each row of dx is also held as a whole: its error norm within
# BWD_ROW_RTOL of the norm of its element scales (a wrong rstd or mean
# moves a whole row; independent roundings give about 2^-9 of it in bf16).
BWD_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -14}
BWD_ROW_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -14}
DW_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -12}


def bwd_kernel_error(dx: torch.Tensor, dw: torch.Tensor, x: torch.Tensor,
                     w: torch.Tensor, dy: torch.Tensor, eps: float = 1e-5,
                     offset: float = 0.0):
    """Hold K2b's (dx, dw) against the plain backward in double on the same
    inputs.  Returns (max abs error of dx, its largest element error in
    units of BWD_RTOL, its largest row error in units of BWD_ROW_RTOL, max
    abs error of dw, its largest element error in units of DW_RTOL): the
    kernel agrees when every ratio is at most 1."""
    rdx, rdw, (sdx, sdw) = _bwd(x, w, dy, eps, offset, torch.float64)
    ex = (dx.double() - rdx).abs()
    ew = (dw.double() - rdw).abs()
    scale = rdx.abs() + sdx
    return (ex.max().item(),
            (ex / (BWD_RTOL[x.dtype] * scale)).max().item(),
            (ex.norm(dim=-1) / (BWD_ROW_RTOL[x.dtype] * scale.norm(dim=-1))
             ).max().item(),
            ew.max().item(),
            (ew / (DW_RTOL[w.dtype] * (rdw.abs() + sdw))).max().item())
