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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, SSMConfig
from ..kernels.ssd_scan.ops import ssd_scan
from .common import dense, rms_norm
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


def mamba2_forward(cfg: ModelConfig, p: dict, hidden: torch.Tensor,
                   ssm_state: torch.Tensor | None = None,
                   conv_state: torch.Tensor | None = None,
                   decode: bool = False):
    """Full Mamba2 block. hidden: [B, S, d].

    Prefill: decode=False, states None -> (y, final_state, conv_state).
    Decode: decode=True with states -> the one-token update.
    """
    s_cfg: SSMConfig = cfg.ssm
    d = cfg.d_model
    di = s_cfg.d_inner(d)
    nh = s_cfg.n_heads(d)
    g, n = s_cfg.n_groups, s_cfg.d_state
    bsz, s, _ = hidden.shape

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
