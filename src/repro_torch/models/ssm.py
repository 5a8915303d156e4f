"""Mamba2 / SSD (state-space duality) blocks — arXiv:2405.21060.

Prefill and training run the chunked dual form: with ``attn_impl ==
"kernel"`` through :func:`~repro_torch.kernels.ssd_scan.ops.ssd_scan` (on
the card the hand-written kernel K3, and under grad its backward K3b),
with ``"chunked"`` or ``"dense"`` through the plain :func:`ssd_chunked`,
whose two three-operand products contract pairwise as the reference's
einsum does (so an export's ``dot_general`` FLOPs are the reference's).  A
failure to build or launch K3 or K3b raises; there is no fallback to the
plain form.  Decode runs the O(1) recurrent update in plain torch, as the
reference does.

On a ``model`` mesh axis (``distributed/tensor_parallel.py::current``) a
rank runs its block of the SSM heads, as the reference's rules lay the
leaves out (``ssm_inner`` and ``ssm_heads`` over the model axis,
``out_norm`` whole): :func:`_mamba2_rank`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, SSMConfig
from ..distributed.tensor_parallel import current
from ..kernels.ssd_scan.ops import ssd_scan
from .common import dense, rms_norm, rms_norm_split
from .params import ParamSpec


def ssm_specs(cfg: ModelConfig, stacked: int = 0) -> dict:
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    g, n = s.n_groups, s.d_state
    conv_ch = di + 2 * g * n
    dt = cfg.dtype

    def p(shape, axes, **kw):
        if stacked:
            return ParamSpec((stacked, *shape), ("layers", *axes),
                             dtype=dt, **kw)
        return ParamSpec(shape, axes, dtype=dt, **kw)

    return {
        # projects to [z, x, B, C, dt]
        "in_proj": p((d, 2 * di + 2 * g * n + nh), ("embed", "ssm_inner"),
                     init="scaled"),
        "conv_w": p((s.d_conv, conv_ch), ("conv", "ssm_inner"),
                    init="scaled"),
        "conv_b": p((conv_ch,), ("ssm_inner",), init="zeros"),
        "a_log": ParamSpec((stacked, nh) if stacked else (nh,),
                           ("layers", "ssm_heads") if stacked
                           else ("ssm_heads",), init="ssm_a", dtype="float32"),
        "dt_bias": p((nh,), ("ssm_heads",), init="zeros"),
        "d_skip": p((nh,), ("ssm_heads",), init="ones"),
        "out_norm": p((di,), ("norm",), init="ones"),
        "out_proj": p((di, d), ("ssm_inner", "embed"), init="scaled"),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Segment sum: out[..., i, j] = sum_{k=j+1..i} x[..., k], -inf above
    the diagonal (the reference's difference of cumulative sums)."""
    l = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~mask, float("-inf"))


def _scaled_rows(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w[..., None] * x as a batched product with no contracted dim (a
    [1, 1] by [1, P] matmul a row): the ``dot_general`` that JAX's einsum
    writes for such a pair, FLOPs and gradients alike."""
    return torch.matmul(w[..., None, None], x[..., None, :])[..., 0, :]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_in: torch.Tensor, c_in: torch.Tensor, chunk: int,
                initial_state: torch.Tensor | None = None):
    """SSD dual form in plain torch, f32 inside.

    x:  [B, S, H, P]  (P = head dim)
    dt: [B, S, H]     (positive step sizes)
    a:  [H]           (negative decay rates)
    b_in, c_in: [B, S, G, N]
    Returns (y [B, S, H, P] in x.dtype, final_state [B, H, P, N] f32).
    """
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    nc = s // chunk
    if nc * chunk != s:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    hpg = h // g

    # [B, C, L, ...] chunked views
    xc = x.reshape(bsz, nc, chunk, h, p).float()
    dtc = dt.reshape(bsz, nc, chunk, h).float()
    bc = b_in.reshape(bsz, nc, chunk, g, n).float()
    cc = c_in.reshape(bsz, nc, chunk, g, n).float()
    da = dtc * a.float()                                  # [B,C,L,H]
    da_cs = torch.cumsum(da, dim=2)                       # within-chunk cumsum
    da_total = da_cs[:, :, -1]                            # [B,C,H]

    # expand groups to heads for score contractions
    bh = bc.repeat_interleave(hpg, dim=3)                 # [B,C,L,H,N]
    ch = cc.repeat_interleave(hpg, dim=3)

    # ---- intra-chunk (dual / attention-like) ----
    lmat = torch.exp(_segsum(da.permute(0, 1, 3, 2)))     # [B,C,H,L,L]
    scores = torch.einsum("bclhn,bcshn->bchls", ch, bh) * lmat
    xdt = xc * dtc[..., None]                             # dt-weighted input
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores, xdt)

    # ---- chunk states ----
    # the reference's three-operand einsums contract pairwise as JAX's
    # einsum does (weights times x first, as a product with no contracted
    # dim), so that the export's dot_general FLOPs are the reference's
    decay_to_end = torch.exp(da_total[:, :, None, :] - da_cs)   # [B,C,L,H]
    states = torch.einsum("bclhp,bclhn->bchpn",
                          _scaled_rows(decay_to_end * dtc, xc), bh)

    # ---- inter-chunk recurrence: emit the state BEFORE each chunk ----
    st = (torch.zeros(bsz, h, p, n, device=x.device)
          if initial_state is None else initial_state.float())
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * torch.exp(da_total[:, c])[:, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                # [B,C,H,P,N]

    # ---- inter-chunk contribution ----
    y_off = _scaled_rows(torch.exp(da_cs), torch.einsum(
        "bchpn,bclhn->bclhp", prev_states, ch))

    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y.to(x.dtype), st


def ssd_decode_step(x, dt, a, b_in, c_in, state):
    """Recurrent update for one token.

    x: [B, 1, H, P], dt: [B, 1, H], b_in/c_in: [B, 1, G, N],
    state: [B, H, P, N] -> (y [B, 1, H, P], new_state f32)."""
    h = x.shape[2]
    hpg = h // b_in.shape[2]
    da = dt[:, 0].float() * a.float()[None, :]                  # [B,H]
    bh = b_in[:, 0].repeat_interleave(hpg, dim=1).float()       # [B,H,N]
    chh = c_in[:, 0].repeat_interleave(hpg, dim=1).float()
    xdt = x[:, 0].float() * dt[:, 0, :, None].float()           # [B,H,P]
    new_state = (state.float() * torch.exp(da)[:, :, None, None]
                 + torch.einsum("bhn,bhp->bhpn", bh, xdt))
    y = torch.einsum("bhpn,bhn->bhp", new_state, chh)
    return y[:, None].to(x.dtype), new_state


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, f32 inside. x: [B, S, C]; w: [K, C] ->
    [B, S, C] in x.dtype, contiguous.  One ``F.conv1d(groups=C)``; in f32
    on the card it runs in full f32 only with
    ``torch.backends.cudnn.allow_tf32`` off."""
    k, ch = w.shape
    xt = F.pad(x.transpose(1, 2).float(), (k - 1, 0))     # [B, C, S+K-1]
    out = F.conv1d(xt, w.float().T[:, None, :], b.float(), groups=ch)
    return torch.empty(x.shape, dtype=x.dtype,
                       device=x.device).copy_(out.transpose(1, 2))


# the leaves laid out along the model axis, and the dim of each
_SHARDED_DIMS = {"in_proj": -1, "conv_w": -1, "conv_b": -1, "a_log": -1,
                 "dt_bias": -1, "d_skip": -1, "out_proj": -2}


def _whole_widths(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    di, nh = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
    gn2 = 2 * s.n_groups * s.d_state
    return {"in_proj": 2 * di + gn2 + nh, "conv_w": di + gn2,
            "conv_b": di + gn2, "a_log": nh, "dt_bias": nh, "d_skip": nh,
            "out_proj": di}


def _take(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x's last dim taken at ``index``, contiguous (K3 reads dt as a
    contiguous tensor); the dim moved first so that the gradient is an
    ``index_put`` along dim 0 (what the export lowers)."""
    return torch.index_select(x.movedim(-1, 0), 0, index).movedim(
        0, -1).contiguous()


def _rank_columns(cfg: ModelConfig, tp, like: torch.Tensor):
    """The rank's columns of the packed [z, x, B, C, dt] projection (its
    heads' z, x and dt, every group's B and C) and of the conv's [x, B, C]
    channels, as index tensors computed from its model coordinate."""
    s = cfg.ssm
    di, nh = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
    gn2 = 2 * s.n_groups * s.d_state
    dl, hl = di // tp.size, nh // tp.size
    m = tp.index(like)
    x_cols = m * dl + torch.arange(dl, device=like.device)
    conv = torch.cat([x_cols, di + torch.arange(gn2, device=like.device)])
    heads = m * hl + torch.arange(hl, device=like.device)
    return torch.cat([x_cols, di + conv, 2 * di + gn2 + heads]), conv


def _mamba2_rank(cfg: ModelConfig, p: dict, hidden: torch.Tensor, tp,
                 ssm_state: torch.Tensor | None):
    """One rank's share of the Mamba2 block on a model axis that divides
    the SSM heads: its heads' z, x and dt with every group's B and C.

    ``hidden`` enters through *f*.  The rank's block of ``in_proj``'s
    columns gives its block of the packed projection, which does not line
    up with the [z, x, B, C, dt] segments, so the blocks are gathered
    (their gradient reduce-scattered: each rank's gradient of the whole is
    a partial, B's and C's from its heads) and the rank's columns taken;
    ``conv_w`` and ``conv_b`` likewise (a leaf the axis does not divide is
    whole, and enters through *f*).  K3 runs over the rank's heads; the
    gated norm over its block of the row (:func:`rms_norm_split`, with
    ``out_norm``'s block); ``out_proj`` row-parallel, leaving through
    *g*."""
    s_cfg: SSMConfig = cfg.ssm
    di = s_cfg.d_inner(cfg.d_model)
    g, n = s_cfg.n_groups, s_cfg.d_state
    whole = _whole_widths(cfg)
    dl, hl = di // tp.size, s_cfg.n_heads(cfg.d_model) // tp.size
    bsz, s, _ = hidden.shape

    def gathered(name):
        w = p[name]
        return (tp.gather_columns(w) if w.shape[-1] < whole[name]
                else tp.copy(w))

    cols, conv = _rank_columns(cfg, tp, hidden)
    if p["in_proj"].shape[-1] < whole["in_proj"]:
        packed = tp.gather_columns(dense(tp.copy(hidden), p["in_proj"]))
    else:
        packed = dense(tp.copy(hidden), tp.copy(p["in_proj"]))
    z, xbc, dt_raw = torch.split(_take(packed, cols),
                                 [dl, dl + 2 * g * n, hl], dim=-1)
    xbc_conv = F.silu(_causal_conv(
        xbc, _take(gathered("conv_w"), conv),
        _take(gathered("conv_b"), conv)))
    x_in, b_in, c_in = torch.split(xbc_conv, [dl, g * n, g * n], dim=-1)
    x_in = x_in.reshape(bsz, s, hl, s_cfg.head_dim)
    b_in = b_in.reshape(bsz, s, g, n)
    c_in = c_in.reshape(bsz, s, g, n)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    chunk = min(s_cfg.chunk_size, s)
    scan = ssd_scan if cfg.attn_impl == "kernel" else ssd_chunked
    y, new_state = scan(x_in, dt, a, b_in, c_in, chunk=chunk,
                        initial_state=ssm_state)
    y = y + x_in * p["d_skip"].to(hidden.dtype)[None, None, :, None]
    y = rms_norm_split(y.reshape(bsz, s, dl) * F.silu(z),
                       tp.block(p["out_norm"], 0, dl), di, cfg.rms_eps)
    out = tp.reduce(dense(y, p["out_proj"]))
    return out, new_state, xbc[:, -(p["conv_w"].shape[0] - 1):]


def _whole_on_the_rank(cfg: ModelConfig, p: dict, tp) -> dict:
    """The layer's leaves whole, for a model axis that does not divide the
    SSM heads: each leaf the axis divides is gathered (its gradient the
    rank's block of the whole's, which every rank computes alike)."""
    whole = _whole_widths(cfg)
    out = dict(p)
    for name, dim in _SHARDED_DIMS.items():
        if p[name].shape[dim] < whole[name]:
            out[name] = tp.whole(p[name], p[name].dim() + dim)
    return out


def mamba2_forward(cfg: ModelConfig, p: dict, hidden: torch.Tensor,
                   ssm_state: torch.Tensor | None = None,
                   conv_state: torch.Tensor | None = None,
                   decode: bool = False):
    """Full Mamba2 block. hidden: [B, S, d].

    Prefill: decode=False, states None -> (y, final_state, conv_state).
    Decode: decode=True with states -> the one-token update.
    On a model axis (prefill and training): :func:`_mamba2_rank` where the
    axis divides the heads, else the layer whole on every model rank.
    """
    s_cfg: SSMConfig = cfg.ssm
    d = cfg.d_model
    di = s_cfg.d_inner(d)
    nh = s_cfg.n_heads(d)
    g, n = s_cfg.n_groups, s_cfg.d_state
    bsz, s, _ = hidden.shape
    tp = current()
    if tp is not None and not decode:
        if p["a_log"].shape[-1] < nh:
            return _mamba2_rank(cfg, p, hidden, tp, ssm_state)
        p = _whole_on_the_rank(cfg, p, tp)

    zxbcdt = dense(hidden, p["in_proj"])
    z, xbc, dt_raw = torch.split(zxbcdt, [di, di + 2 * g * n, nh], dim=-1)
    k = p["conv_w"].shape[0]
    if decode:
        # rolling conv state: [B, K-1, conv_ch]
        conv_in = torch.cat([conv_state, xbc], dim=1)
        new_conv_state = conv_in[:, 1:]
        xbc_conv = (torch.einsum("bkc,kc->bc", conv_in[:, -k:].float(),
                                 p["conv_w"].float())
                    + p["conv_b"].float())
        xbc_conv = F.silu(xbc_conv)[:, None].to(hidden.dtype)
    else:
        xbc_conv = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
        new_conv_state = xbc[:, -(k - 1):]

    # column slices of xbc_conv, read in place by K3
    x_in, b_in, c_in = torch.split(xbc_conv, [di, g * n, g * n], dim=-1)
    x_in = x_in.reshape(bsz, s, nh, s_cfg.head_dim)
    b_in = b_in.reshape(bsz, s, g, n)
    c_in = c_in.reshape(bsz, s, g, n)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())

    if decode:
        y, new_state = ssd_decode_step(x_in, dt, a, b_in, c_in, ssm_state)
    elif cfg.attn_impl == "kernel":
        y, new_state = ssd_scan(x_in, dt, a, b_in, c_in,
                                chunk=min(s_cfg.chunk_size, s),
                                initial_state=ssm_state)
    else:
        y, new_state = ssd_chunked(x_in, dt, a, b_in, c_in,
                                   chunk=min(s_cfg.chunk_size, s),
                                   initial_state=ssm_state)
    y = y + x_in * p["d_skip"].to(hidden.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, di)
    y = rms_norm(y * F.silu(z), p["out_norm"], cfg.rms_eps)
    out = dense(y, p["out_proj"])
    return out, new_state, new_conv_state
