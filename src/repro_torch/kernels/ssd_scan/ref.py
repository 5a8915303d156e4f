"""Plain PyTorch versions of the SSD scan (K3): the CPU path and the card's
reference.

* :func:`ssd_scan_ref` is K3's function, the whole chunked scan: the
  cumulative decays inside each chunk, each chunk's local state and the
  inter-chunk recurrence (:func:`chunk_states`), then per chunk the
  intra-chunk dual form plus the inbound state's term (:func:`ssd_chunk_ref`);
* :func:`ssd_chunk_ref` is the TPU kernel's function on one chunked
  sequence, given the decays and the inbound states;
* :func:`ssd_ref` is the sequential oracle, the exact linear-time
  recurrence that the chunked forms must match;
* :func:`kernel_error` holds K3's y and final state against
  ``ssd_scan_ref`` in f32.

Layouts are the sequence layouts the model hands the kernel: x [B, S, H, P],
dt [B, S, H] f32, a [H] f32, B and C [B, S, G, N] with G dividing H (head h
reads group ``h // (H / G)``), states [B, H, P, N] f32; ``dacs`` [B, S, H]
is the cumulative sum of ``dt * a`` inside each chunk of L rows, and the
per-chunk states are [B, C, H, P, N] with C = S / L.
"""
from __future__ import annotations

import torch

# How far K3 may be from the plain version on the same inputs, with the
# plain version's decays and weights computed in f32 as K3 computes them and
# its sums of products in double (``kernel_error``).  Both take dacs as the
# f32 rounding of a cumulative sum taken in double, so their decays agree to
# an ulp of dacs.  In bf16 K3 rounds two
# things for the tensor cores: the decayed, dt-weighted scores P = (C B^T) *
# exp(dacs_i - dacs_j) * dt_j (x stays exact: it is bf16 already), and the
# output.  Neither f32 state goes in rounded whole: the inbound state S and
# the weighted x of the local state, w_t x_t with w_t = exp(datot - dacs_t)
# dt_t, each go in as two bf16 parts (hi + lo, off by at most u^2 of the
# value).  Rounded whole, the inbound state's error (about u / sqrt(3) of
# each element, of random sign) meets C's sum over N, which cancels to about
# 1/sqrt(N) of its terms, and moved rows of y by about 7 u at N = 128 (1.74
# of ROW_RTOL, measured on the card); a local state built from w x rounded to
# bf16 carries an error of the same size into every later chunk's inbound
# state.  TF32 would keep 10 bits of w x, three more than bf16 but not the
# 16 of hi + lo, at half the bf16 rate; hi + lo costs two bf16 products.
# With bf16's unit roundoff u = 2^-8, an element of y then moves by at most
# u * (sum_j |P_ij x_j| + |y_i|) + u^2 exp(dacs_i) |C_i| |S|^T
# <= u * scale, where ``scale`` is |y| plus the same scan run on |x|, |B|,
# |C| and |initial state| (dt and the decays are positive, so that run bounds
# every path into y_i, the inbound state's included).  Products of two bf16
# numbers are exact in f32 and their sums add at most (N + L) 2^-24 of the
# scale per chunk.  Each element is held within RTOL * scale, a margin of 2
# over that bound; the final state's elements likewise, against its own
# scale.  In f32 only the order of the sums (N + L = 384 terms at
# mamba2-370m: 2^-15.4) and expf differ: 2^-14 leaves a margin of 2.
# Each row's error norm (over P for y, over N for the state) is held within
# a fraction of the row's norm.  For y, rounding P after the sum over N,
# errors of random sign give about u/2 of it (0.33 of 2^-6 at 4x2048, 32
# heads, on the CPU), so the bf16 row tolerance is 4 u; a dropped state
# term or a dropped diagonal moves whole rows by far more.  The state is
# never rounded to bf16 at all: its error is the hi + lo split's u^2 and the
# f32 sums', below 2^-15 of a row, so STATE_ROW_RTOL is 2^-12 in both
# dtypes, a margin of 8; a state built from w x rounded whole to bf16 moves
# its rows by about u / sqrt(3) (2^-8.8), 8 times that.
RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -14}
ROW_RTOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 2.0 ** -12}
STATE_ROW_RTOL = {torch.bfloat16: 2.0 ** -12, torch.float32: 2.0 ** -12}


def _chunked(t: torch.Tensor, nc: int) -> torch.Tensor:
    """[B, S, ...] -> [B, C, L, ...] in f32."""
    return t.float().reshape(t.shape[0], nc, t.shape[1] // nc, *t.shape[2:])


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{k=j+1..i} x[..., k] for j <= i, else -inf;
    summed term by term, not as a difference of cumulative sums, which
    would lose a small decay next to the large sums of earlier chunks."""
    t = x.shape[-1]
    xx = x[..., :, None].expand(*x.shape, t)                   # [..., k, j]
    below = torch.ones(t, t, dtype=torch.bool, device=x.device).tril(-1)
    out = torch.cumsum(xx.masked_fill(~below, 0.0), dim=-2)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~causal, float("-inf"))


def chunk_states(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b_in: torch.Tensor, chunk: int,
                 initial_state: torch.Tensor | None = None,
                 sums: torch.dtype = torch.float32):
    """The decays and states of the chunked scan, in f32 with the sums of
    products taken in ``sums``.  Returns ``dacs`` [B, S, H] (the cumulative
    sum of dt * a inside each chunk, taken in double and rounded once), the
    inbound state of each chunk [B, C, H, P, N] and the final state
    [B, H, P, N], both f32."""
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    nc = s // chunk
    dtc = dt.float().reshape(bsz, nc, chunk, h)
    dacs = torch.cumsum((dtc * a.float()).double(), dim=2).float()  # [B,C,L,H]
    datot = dacs[:, :, -1]                                     # [B,C,H]
    # local state of each chunk: sum_t exp(datot - dacs_t) dt_t x_t (x) B_t,
    # heads of a group against the group's B in place
    w = (torch.exp(datot[:, :, None] - dacs) * dtc).reshape(
        bsz, nc, chunk, g, h // g)
    xw = x.float().reshape(bsz, nc, chunk, g, h // g, p) * w[..., None]
    local = torch.einsum("bclgn,bclgkp->bcgkpn",
                         b_in.float().reshape(bsz, nc, chunk, g, n).to(sums),
                         xw.to(sums))
    # inter-chunk recurrence S_{c+1} = exp(datot_c) S_c + local_c as one
    # product: z = [S_0, local_0 .. local_{C-1}] decayed by the segment sums
    # of [0, datot_0 .. datot_{C-1}] gives [S_0 .. S_C]
    init = (torch.zeros(bsz, h, p, n, device=x.device)
            if initial_state is None else initial_state.float())
    z = torch.cat([init[:, None].to(sums),
                   local.reshape(bsz, nc, h, p, n)], dim=1)
    e = torch.cat([torch.zeros_like(datot[:, :1]), datot], dim=1)
    decay = torch.exp(_segsum(e.transpose(1, 2)))              # [B,H,C+1,C+1]
    states = torch.einsum("bhzc,bchpn->bzhpn", decay.to(sums), z).float()
    return dacs.reshape(bsz, s, h), states[:, :-1], states[:, -1]


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b_in: torch.Tensor, c_in: torch.Tensor, chunk: int,
                 initial_state: torch.Tensor | None = None,
                 sums: torch.dtype = torch.float32):
    """K3's function in plain torch: :func:`chunk_states`, then
    :func:`ssd_chunk_ref` with the inbound states, the sums of products
    taken in ``sums``.  Returns (y [B, S, H, P] in x.dtype, final_state
    [B, H, P, N] f32)."""
    dacs, inbound, final = chunk_states(x, dt, a, b_in, chunk, initial_state,
                                        sums)
    y, _ = ssd_chunk_ref(x, dt.float(), b_in, c_in, dacs, inbound, sums)
    return y, final


def ssd_chunk_ref(x: torch.Tensor, dt: torch.Tensor, b_in: torch.Tensor,
                  c_in: torch.Tensor, dacs: torch.Tensor,
                  states: torch.Tensor, sums: torch.dtype = torch.float32):
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
    scores = torch.einsum("bclgn,bcsgn->bcgls", cc.to(sums),
                          bc.to(sums))                        # [B,C,G,L,L]
    dah = da.permute(0, 1, 3, 4, 2)                             # [B,C,G,K,L]
    diff = dah[..., :, None] - dah[..., None, :]                # [..., L, L]
    causal = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(diff.masked_fill(~causal, float("-inf")))
    y = torch.einsum("bcgkls,bcsgkp->bclgkp",
                     scores[:, :, :, None] * decay.to(sums), dtx.to(sums))
    # the inbound state's term
    y = y + (torch.einsum("bclgn,bcgkpn->bclgkp", cc.to(sums), st.to(sums))
             * torch.exp(da).to(sums)[..., None])
    # the outbound chunk state
    w = torch.exp(da[:, :, -1:] - da)                           # [B,C,L,G,K]
    out = torch.einsum("bclgkp,bclgn->bcgkpn", (dtx * w[..., None]).to(sums),
                       bc.to(sums))
    return (y.reshape(bsz, s, h, p).to(x.dtype),
            out.reshape(bsz, nc, h, p, n).float())


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


def kernel_error(y: torch.Tensor, final_state: torch.Tensor,
                 x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b_in: torch.Tensor, c_in: torch.Tensor, chunk: int,
                 initial_state: torch.Tensor | None = None
                 ) -> tuple[float, float, float]:
    """Hold K3's ``y`` and ``final_state`` against ``ssd_scan_ref`` on the
    same inputs, its decays and weights in f32 as K3 computes them and its
    sums of products in double: on a row of y that cancels to a thousandth
    of its terms, f32 sums would put the reference's own rounding above
    the f32 row tolerance.  Returns the max abs error (of y and the state), the
    largest element error in units of its tolerance (RTOL * scale) and the
    largest row error in units of its row tolerance (ROW_RTOL for y,
    STATE_ROW_RTOL for the state): the kernel agrees when both ratios are
    at most 1."""
    init = None if initial_state is None else initial_state.float()
    ref, ref_st = ssd_scan_ref(x.float(), dt, a, b_in.float(), c_in.float(),
                               chunk, init, sums=torch.float64)
    mag, mag_st = ssd_scan_ref(x.float().abs(), dt, a, b_in.float().abs(),
                               c_in.float().abs(), chunk,
                               None if init is None else init.abs(),
                               sums=torch.float64)
    rtol = RTOL[x.dtype]
    max_err, elem, row = 0.0, 0.0, 0.0
    for out, r, m, row_tol in ((y, ref, mag, ROW_RTOL[x.dtype]),
                               (final_state, ref_st, mag_st,
                                STATE_ROW_RTOL[x.dtype])):
        err = out.float() - r
        max_err = max(max_err, err.abs().max().item())
        elem = max(elem, (err.abs() / (rtol * (r.abs() + m)).clamp_min(1e-30)
                          ).max().item())
        row = max(row, (err.norm(dim=-1) / (row_tol * r.norm(dim=-1))
                        .clamp_min(1e-30)).max().item())
    return max_err, elem, row
