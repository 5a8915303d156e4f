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
  ``ssd_scan_ref`` in f32;
* :func:`ssd_scan_states_ref` is K3's function when a gradient will be
  asked for: the scan's outputs and each chunk's inbound state;
* :func:`ssd_scan_bwd_ref` is K3b's function, the scan's backward, and
  :func:`bwd_kernel_error` holds K3b against it in double.

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
    return ssd_scan_states_ref(x, dt, a, b_in, c_in, chunk, initial_state,
                               sums)[:2]


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
                 initial_state: torch.Tensor | None = None,
                 states: torch.Tensor | None = None
                 ) -> tuple[float, float, float]:
    """Hold K3's ``y`` and ``final_state`` against ``ssd_scan_ref`` on the
    same inputs, its decays and weights in f32 as K3 computes them and its
    sums of products in double: on a row of y that cancels to a thousandth
    of its terms, f32 sums would put the reference's own rounding above
    the f32 row tolerance.  Returns the max abs error (of y and the state), the
    largest element error in units of its tolerance (RTOL * scale) and the
    largest row error in units of its row tolerance (ROW_RTOL for y,
    STATE_ROW_RTOL for the state): the kernel agrees when both ratios are
    at most 1.  With ``states`` (the inbound states K3 writes for its
    backward) those are held as the final state is."""
    init = None if initial_state is None else initial_state.float()
    ref, ref_st, ref_in = ssd_scan_states_ref(
        x.float(), dt, a, b_in.float(), c_in.float(), chunk, init,
        sums=torch.float64)
    mag, mag_st, mag_in = ssd_scan_states_ref(
        x.float().abs(), dt, a, b_in.float().abs(), c_in.float().abs(),
        chunk, None if init is None else init.abs(), sums=torch.float64)
    rtol = RTOL[x.dtype]
    max_err, elem, row = 0.0, 0.0, 0.0
    held = [(y, ref, mag, ROW_RTOL[x.dtype]),
            (final_state, ref_st, mag_st, STATE_ROW_RTOL[x.dtype])]
    if states is not None:
        held.append((states, ref_in, mag_in, STATE_ROW_RTOL[x.dtype]))
    for out, r, m, row_tol in held:
        err = out.float() - r
        max_err = max(max_err, err.abs().max().item())
        elem = max(elem, (err.abs() / (rtol * (r.abs() + m)).clamp_min(1e-30)
                          ).max().item())
        row = max(row, (err.norm(dim=-1) / (row_tol * r.norm(dim=-1))
                        .clamp_min(1e-30)).max().item())
    return max_err, elem, row


def ssd_scan_states_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                        b_in: torch.Tensor, c_in: torch.Tensor, chunk: int,
                        initial_state: torch.Tensor | None = None,
                        sums: torch.dtype = torch.float32):
    """:func:`ssd_scan_ref` that also returns each chunk's inbound state:
    (y, final_state, states [B, C, H, P, N] f32), the states K3 writes for
    its backward when a gradient will be asked for."""
    dacs, inbound, final = chunk_states(x, dt, a, b_in, chunk, initial_state,
                                        sums)
    y, _ = ssd_chunk_ref(x, dt.float(), b_in, c_in, dacs, inbound, sums)
    return y, final, inbound


def ssd_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     b_in: torch.Tensor, c_in: torch.Tensor, chunk: int,
                     initial_state: torch.Tensor | None,
                     states: torch.Tensor | None, dy: torch.Tensor,
                     dfinal: torch.Tensor | None,
                     sums: torch.dtype = torch.float32):
    """K3b's function: the gradients of :func:`ssd_scan_ref` given dy (the
    gradient of y) and dfinal (of the final state; None for 0), written
    out in ``sums`` (the decays' exponentials too).  ``states``, the
    inbound states K3 wrote, are recomputed by :func:`chunk_states` and
    not read.  Per (batch, head, chunk), with G_c the gradient reaching the
    state after chunk c:

        G_{c-1} = exp(T) G_c + sum_i exp(dacs_i) dy_i (x) C_i
        dx_j = dt_j [sum_{i>=j} (C_i.B_j) e_ij dy_i + exp(T - dacs_j) G B_j]
        dC_i = sum_{j<=i} (dy_i.x_j) dt_j e_ij B_j + exp(dacs_i) S^T dy_i
        dB_j = sum_{i>=j} (dy_i.x_j) dt_j e_ij C_i
               + exp(T - dacs_j) dt_j G^T x_j

    with e_ij = exp(dacs_i - dacs_j) and T = dacs_{L-1}; dB and dC summed
    over a group's heads.  The exponents' gradient: M_ij = (C_i.B_j)
    (dy_i.x_j) dt_j e_ij for i > j (the diagonal's exponent is 0 whatever
    dacs is, so it takes no part), r_i = exp(dacs_i) dy_i.(S C_i) and q_j
    = dt_j x_j.(exp(T - dacs_j) G B_j); then g = d(dt a) is, at row k,

        sum_{i>=k} (sum_j M_ij - sum_l M_li + r_i) + sum_{j<k} q_j
        + exp(T) <G, S>

    (the q_j reach T and dacs_j with opposite signs; summing those left of
    k avoids cancelling them), so ddt = x.(dx / dt) + a g and da = sum dt
    g.  Returns (dx, ddt, da, dB, dC, dinitial), each in its input's dtype;
    dinitial is the initial state's gradient [B, H, P, N] f32 (float64 when
    ``sums`` is), given even when there is no initial state."""
    del states
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    nc, k = s // chunk, h // g
    f, dev = sums, x.device
    dacs, inbound, _ = chunk_states(x, dt, a, b_in, chunk, initial_state,
                                    sums)

    def chunked(t, *tail):
        return t.to(f).reshape(bsz, nc, chunk, *tail)
    xc, dyc = chunked(x, g, k, p), chunked(dy, g, k, p)      # [B,C,L,G,K,P]
    bc, cc = chunked(b_in, g, n), chunked(c_in, g, n)        # [B,C,L,G,N]
    dtc, dac = chunked(dt, g, k), chunked(dacs, g, k)        # [B,C,L,G,K]
    st = inbound.to(f).reshape(bsz, nc, g, k, p, n)
    tot = dac[:, :, -1]                                      # [B,C,G,K]
    ea = torch.exp(dac)
    et = torch.exp(tot[:, :, None] - dac)                    # exp(T - dacs)

    # the reverse recurrence of the state's gradient
    local = torch.einsum("bclgkp,bclgn->bcgkpn", dyc * ea[..., None], cc)
    grad = (torch.zeros(bsz, g, k, p, n, dtype=f, device=dev)
            if dfinal is None else dfinal.to(f).reshape(bsz, g, k, p, n))
    after = [grad] * nc
    for c in reversed(range(nc)):
        after[c] = grad
        grad = torch.exp(tot[:, c])[..., None, None] * grad + local[:, c]
    gst = torch.stack(after, dim=1)                          # [B,C,G,K,P,N]

    # inside each chunk: rows i, j as the last two dims
    dah = dac.permute(0, 1, 3, 4, 2)                         # [B,C,G,K,L]
    row = torch.arange(chunk, device=dev)
    lower = row[:, None] >= row[None, :]
    e = torch.exp((dah[..., :, None] - dah[..., None, :]).masked_fill(
        ~lower, float("-inf")))                              # mask first
    cb = torch.einsum("bclgn,bcsgn->bcgls", cc, bc)[:, :, :, None]
    dxm = torch.einsum("bclgkp,bcsgkp->bcgkls", dyc, xc)
    w = cb * e
    v = dxm * e * dtc.permute(0, 1, 3, 4, 2)[..., None, :]
    m = (cb * v).masked_fill(~(row[:, None] > row[None, :]), 0.0)

    dxs = torch.einsum("bcgkpn,bclgn->bclgkp", gst, bc) * et[..., None]
    dxt = torch.einsum("bcgkls,bclgkp->bcsgkp", w, dyc) + dxs   # dx / dt
    dcs = torch.einsum("bcgkpn,bclgkp->bclgkn", st, dyc * ea[..., None])
    dc = torch.einsum("bcgkls,bcsgn->bclgn", v, bc) + dcs.sum(4)
    db = (torch.einsum("bcgkls,bclgn->bcsgn", v, cc)
          + torch.einsum("bcgkpn,bclgkp->bclgn", gst,
                         xc * (et * dtc)[..., None]))

    r = (dcs * cc[:, :, :, :, None]).sum(-1)                 # [B,C,L,G,K]
    q = (xc * dxs).sum(-1) * dtc
    ddacs = (m.sum(-1) - m.sum(-2)).permute(0, 1, 4, 2, 3) + r
    suffix = torch.flip(torch.cumsum(torch.flip(ddacs, [2]), 2), [2])
    left = torch.cat([torch.zeros_like(q[:, :, :1]),
                      torch.cumsum(q, 2)[:, :, :-1]], dim=2)
    gd = (suffix + left
          + (torch.exp(tot) * (gst * st).sum((-1, -2)))[:, :, None])
    ddt = (xc * dxt).sum(-1) + a.to(f).reshape(g, k) * gd
    da = (dtc * gd).sum((0, 1, 2)).reshape(h)
    return ((dxt * dtc[..., None]).reshape(bsz, s, h, p).to(x.dtype),
            ddt.reshape(bsz, s, h).to(dt.dtype), da.to(a.dtype),
            db.reshape(bsz, s, g, n).to(b_in.dtype),
            dc.reshape(bsz, s, g, n).to(c_in.dtype),
            grad.reshape(bsz, h, p, n).to(torch.promote_types(
                f, torch.float32)))


# How far K3b may be from ``ssd_scan_bwd_ref`` in double on the same inputs
# (``bwd_kernel_error``).  K3b computes in f32 from its inputs as they are
# (bf16 is exact in f32) and rounds dx, dB and dC once to the input dtype:
# in bf16 that is at most u/2 = 2^-9 of the element, so BWD_RTOL holds
# those three within 2^-8 of (|element| + the gradient's RMS), twice the
# rounding bound; the RMS term takes the f32 sums' error on an element that
# cancels.  The f32 outputs (ddt, da, the initial state's gradient) and the
# f32 path's every output carry only the f32 sums' error (L + N + P terms a
# product, reverse cumulative sums of L rows, the inbound states K3 wrote
# from its hi + lo parts, off by about 2^-16 of the state): 2^-14 of the
# same scale.  A dropped term, a mask off by one or a sign moves whole rows
# by far more than either.
BWD_RTOL = {torch.bfloat16: 2.0 ** -8, torch.float32: 2.0 ** -14}


def bwd_kernel_error(grads, x, dt, a, b_in, c_in, chunk, initial_state, dy,
                     dfinal):
    """Hold K3b's (dx, ddt, da, dB, dC, dinitial) against
    ``ssd_scan_bwd_ref`` with every input in double.  Returns, for each,
    (max abs error, largest element error in units of its tolerance,
    largest row error in units of its tolerance): the tolerance of an
    element is BWD_RTOL of its output dtype times |element| plus the
    gradient's RMS, of a row the norm of those (rows along the last dim;
    da is one row).  The kernel agrees when every ratio is at most 1."""
    d64 = [t.double() for t in (x, dt, a, b_in, c_in)]
    refs = ssd_scan_bwd_ref(
        *d64, chunk, None if initial_state is None else
        initial_state.double(), None, dy.double(),
        None if dfinal is None else dfinal.double(), sums=torch.float64)
    out = []
    for g, r in zip(grads, refs):
        rtol = BWD_RTOL[g.dtype]
        err = g.double() - r.double()
        scale = r.double().abs() + r.double().square().mean().sqrt()
        elem = err.abs() / (rtol * scale).clamp_min(1e-300)
        row = err.norm(dim=-1) / (rtol * scale.norm(dim=-1)).clamp_min(1e-300)
        out.append((err.abs().max().item(), elem.max().item(),
                    row.max().item()))
    return out
