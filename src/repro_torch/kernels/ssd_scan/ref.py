"""Plain PyTorch versions of the SSD scan (K3): the CPU path and the card's
reference.

* :func:`ssd_chunk_ref` is K3's function on one chunked sequence: per
  (batch, head, chunk) the intra-chunk dual form plus the inbound state's
  term, and the outbound chunk state that the TPU kernel also wrote;
* :func:`ssd_ref` is the sequential oracle, the exact linear-time
  recurrence that the chunked forms must match;
* :func:`kernel_error` holds K3's output against ``ssd_chunk_ref`` in f32.

Layouts are the sequence layouts the model hands the kernel: x [B, S, H, P],
dt and dacs [B, S, H] (f32; ``dacs`` is the cumulative sum of ``dt * a``
inside each chunk), B and C [B, S, G, N] with G dividing H (head h reads
group ``h // (H / G)``), states [B, C, H, P, N] f32 with C = S / L chunks.
"""
from __future__ import annotations

import torch

# How far K3 may be from the plain version computed in f32 on the same
# inputs.  In bf16 K3 rounds two things for the tensor cores: the decayed,
# dt-weighted scores P = (C B^T) * exp(dacs_i - dacs_j) * dt_j (x stays
# exact: it is bf16 already), and the output.  The f32 inbound state goes in
# as two bf16 parts (hi + lo, off by at most u^2 |state|): rounded whole, its
# error would meet C's sum over N, which cancels to about 1/sqrt(N) of its
# terms, and move rows by about 7 u at N = 128.  With bf16's unit roundoff
# u = 2^-8 an element then moves by at most
# u * (sum_j |P_ij x_j| + |y_i|) + u^2 exp(dacs_i) |C_i| |state|^T
# <= u * scale, where ``scale`` is |y| plus the plain version run on |x|,
# |B|, |C| and |state| (dt and the decays are positive).  Products C B^T
# are exact in f32 and their sums add at most (N + L) 2^-24 of the scale.
# Each element is held within RTOL * scale, a margin of 2 over that bound.
# In f32 only the order of the sums (N + L = 384 terms at mamba2-370m:
# 2^-15.4) and expf differ: 2^-14 leaves a margin of 2.  Each row's error
# norm (over P) is held within ROW_RTOL of the row's norm.  Rounding P
# after the sum over N, errors of random sign give about u/2 of it (0.33 of
# 2^-6 at 4x2048, 32 heads, on the CPU), so the bf16 row tolerance is 4 u;
# a dropped state term or a dropped diagonal moves whole rows by far more.
RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -14}
ROW_RTOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 2.0 ** -12}


def _chunked(t: torch.Tensor, nc: int) -> torch.Tensor:
    """[B, S, ...] -> [B, C, L, ...] in f32."""
    return t.float().reshape(t.shape[0], nc, t.shape[1] // nc, *t.shape[2:])


def ssd_chunk_ref(x: torch.Tensor, dt: torch.Tensor, b_in: torch.Tensor,
                  c_in: torch.Tensor, dacs: torch.Tensor,
                  states: torch.Tensor):
    """Per (batch, head, chunk), with i, j rows of the chunk:

        y_i = sum_{j <= i} (C_i . B_j) exp(dacs_i - dacs_j) dt_j x_j
              + exp(dacs_i) C_i . state^T
        out_state = sum_t exp(dacs_L - dacs_t) dt_t x_t (x) B_t

    Returns (y [B, S, H, P] in x.dtype, out_states [B, C, H, P, N] f32)."""
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    nc = states.shape[1]
    hpg = h // g
    xc = _chunked(x, nc).reshape(bsz, nc, -1, g, hpg, p)       # [B,C,L,G,K,P]
    dtc = _chunked(dt, nc).reshape(bsz, nc, -1, g, hpg)
    bc, cc = _chunked(b_in, nc), _chunked(c_in, nc)            # [B,C,L,G,N]
    da = _chunked(dacs, nc).reshape(bsz, nc, -1, g, hpg)       # [B,C,L,G,K]
    st = states.float().reshape(bsz, nc, g, hpg, p, n)
    l = xc.shape[2]
    dtx = xc * dtc[..., None]

    # intra-chunk: the mask goes on BEFORE the exponential; exp(dacs_i -
    # dacs_j) for i < j overflows once |dt a| L is a few hundred
    scores = torch.einsum("bclgn,bcsgn->bcgls", cc, bc)         # [B,C,G,L,L]
    dah = da.permute(0, 1, 3, 4, 2)                             # [B,C,G,K,L]
    diff = dah[..., :, None] - dah[..., None, :]                # [..., L, L]
    causal = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(diff.masked_fill(~causal, float("-inf")))
    y = torch.einsum("bcgkls,bcsgkp->bclgkp", scores[:, :, :, None] * decay,
                     dtx)
    # the inbound state's term
    y = y + (torch.einsum("bclgn,bcgkpn->bclgkp", cc, st)
             * torch.exp(da)[..., None])
    # the outbound chunk state
    w = torch.exp(da[:, :, -1:] - da)                           # [B,C,L,G,K]
    out = torch.einsum("bclgkp,bclgn->bcgkpn", dtx * w[..., None], bc)
    return (y.reshape(bsz, s, h, p).to(x.dtype),
            out.reshape(bsz, nc, h, p, n))


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b_in: torch.Tensor, c_in: torch.Tensor,
            initial_state: torch.Tensor | None = None):
    """The sequential recurrence, token by token:

        h_t = exp(dt_t a) h_{t-1} + dt_t (x_t (x) B_t),   y_t = h_t . C_t

    x: [B, S, H, P], dt: [B, S, H], a: [H], b_in/c_in: [B, S, G, N].
    Returns (y [B, S, H, P] in x.dtype, final_state [B, H, P, N] f32)."""
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    hpg = h // g
    bh = b_in.float().repeat_interleave(hpg, dim=2)             # [B,S,H,N]
    ch = c_in.float().repeat_interleave(hpg, dim=2)
    xf, dtf, af = x.float(), dt.float(), a.float()
    state = (torch.zeros(bsz, h, p, n, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * af)                       # [B,H]
        state = state * decay[:, :, None, None] + torch.einsum(
            "bhn,bhp->bhpn", bh[:, t], xf[:, t] * dtf[:, t, :, None])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state


def kernel_error(y: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                 b_in: torch.Tensor, c_in: torch.Tensor, dacs: torch.Tensor,
                 states: torch.Tensor) -> tuple[float, float, float]:
    """Hold K3's output ``y`` against ``ssd_chunk_ref`` in f32 on the same
    inputs.  Returns the max abs error, the largest element error in units
    of its tolerance (RTOL * scale) and the largest row error in units of
    ROW_RTOL: the kernel agrees when both ratios are at most 1."""
    ref, _ = ssd_chunk_ref(x.float(), dt, b_in.float(), c_in.float(), dacs,
                           states)
    mag, _ = ssd_chunk_ref(x.float().abs(), dt, b_in.float().abs(),
                           c_in.float().abs(), dacs, states.abs())
    err = y.float() - ref
    elem = err.abs() / (RTOL[x.dtype] * (ref.abs() + mag)).clamp_min(1e-30)
    row = err.norm(dim=-1) / (ROW_RTOL[x.dtype]
                              * ref.norm(dim=-1)).clamp_min(1e-30)
    return err.abs().max().item(), elem.max().item(), row.max().item()
