"""The port's CUDA kernels against their plain versions on the card: K1
(flash attention, head_dim 32 to 160), K2 (RMSNorm) and K3 (the SSD scan),
each at a few shapes and layouts of the serving paths, and K1's
log-sum-exp, K3's chunk states, K1b, K2b and K3b (their backwards) and the
gradients of a small model through them, in f32 and bf16, with the
tolerances of each kernel's ``ref.py``; a small hybrid (zamba2's head width
and SSM widths) served through K1, K2 and K3; K1 at MLA's widths (query
192, value 128) and K1b at them, K2 on MLA's latent rows, a small MLA
model served through K1 and K2, and its donated Adafactor step equal to
the functional one; and the sparse MoE layer on
the card against its CPU run, and twice to equal bits, forward and
backward; K1 and K1b at qwen2-vl-7b's GQA group of 7 and at hubert-xlarge's
head_dim 80 without a causal mask, K2 and K2b at their widths (3584, 1280),
and small models of both ids (M-RoPE streams, frame embeddings) served and
trained through the kernels.  Every test is marked ``cuda`` and skips
without a card.  The file imports neither JAX nor the JAX package, so it
also runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_cuda.py -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as k1_ops
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bwd)
from repro_torch.kernels.flash_attention.ref import (
    bwd_kernel_error as k1b_error, kernel_error as flash_error, lse_error)
from repro_torch.kernels.rmsnorm import ops as k2_ops
from repro_torch.kernels.rmsnorm import ref as k2_ref
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_bwd
from repro_torch.kernels.rmsnorm.ref import (
    bwd_kernel_error as k2b_error, kernel_error as rmsnorm_error,
    rmsnorm_ref)
from repro_torch.kernels.ssd_scan import ops as k3_ops
from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_bwd
from repro_torch.kernels.ssd_scan.ref import (
    bwd_kernel_error as k3b_error, kernel_error as ssd_error)
from repro_torch.models import common as model_common
from repro_torch.models.params import init_params
from repro_torch.models.registry import get_smoke_config
from repro_torch.models.transformer import (decode_step, init_cache_specs,
                                            model_specs, prefill)
from repro_torch.train.checkpoint import _flatten
from repro_torch.train.loop import _value_and_grad
from repro_torch.train.optimizer import tree_leaves, tree_map


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _qkv(seed, b, hq, hkv, sq, skv, d):
    return _normal(seed, (b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))


def _ssd_inputs(seed, b, s, h, p, g, n):
    """x, dt (softplus of a normal), a (negative), B, C and an initial
    state, as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x, bi, ci, st0 = (rng.standard_normal(shape).astype(np.float32)
                      for shape in ((b, s, h, p), (b, s, g, n), (b, s, g, n),
                                    (b, h, p, n)))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    return x, dt, a, bi, ci, st0


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
            for a in arrays]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window,cap,q_offset,bshd", [
    (2, 8, 2, 256, 256, 64, True, 0, 0.0, 0, False),
    (2, 8, 2, 1024, 1024, 64, True, 0, 0.0, 0, True),
    (1, 4, 4, 200, 200, 32, True, 48, 0.0, 0, False),
    (1, 8, 2, 100, 356, 128, True, 0, 30.0, 256, False),
    (2, 4, 2, 130, 70, 64, False, 0, 0.0, 0, False),
    # across the bf16 kernel's 128-row query items and 128-key tiles (64
    # keys at d=128) and its ring of stages: ragged Sq and Skv
    (2, 8, 2, 1, 300, 64, True, 0, 0.0, 299, False),
    (2, 8, 2, 127, 333, 64, True, 0, 0.0, 0, False),
    (2, 8, 2, 129, 200, 64, False, 0, 0.0, 0, False),
    (1, 8, 2, 1000, 1111, 64, True, 0, 0.0, 111, False),
    # a window edge inside a tile; q_offset with Sq < Skv
    (1, 8, 2, 700, 700, 64, True, 100, 0.0, 0, False),
    (1, 8, 2, 300, 812, 64, True, 0, 0.0, 512, False),
    # group 1 and group 8
    (1, 8, 8, 256, 256, 64, True, 0, 0.0, 0, False),
    (1, 16, 2, 256, 256, 64, True, 0, 0.0, 0, False),
    # d 32, 64 and 128 in the strided [B, S, H, D] layout
    (2, 8, 2, 384, 384, 32, True, 0, 0.0, 0, True),
    (1, 8, 2, 1000, 1000, 64, True, 0, 0.0, 0, True),
    (1, 8, 2, 520, 520, 128, True, 0, 0.0, 0, True),
    # d 80 (zamba2-2.7b; padded to 96 inside the kernel) and 160
    # (stablelm-12b; 64-key tiles): strided and ragged with an offset, a
    # window with a cap, no causal mask, one query row
    (1, 8, 2, 1000, 1111, 80, True, 0, 0.0, 111, True),
    (1, 8, 2, 1000, 1111, 160, True, 0, 0.0, 111, True),
    (2, 8, 4, 700, 700, 160, True, 200, 30.0, 0, False),
    (2, 4, 4, 300, 333, 80, False, 0, 0.0, 0, False),
    (1, 4, 4, 1, 300, 80, True, 0, 0.0, 299, False),
])
def test_flash_kernel_on_card(cuda, dtype, b, hq, hkv, sq, skv, d, causal,
                              window, cap, q_offset, bshd):
    # bshd: [B, S, H, D] tensors seen as [B, H, S, D], as gqa_forward passes
    # its projections; the tolerances are ref.RTOL and ref.ROW_RTOL
    q, k, v = _qkv(8, b, hq, hkv, sq, skv, d)
    if bshd:
        q, k, v = (np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                   for a in (q, k, v))
    q, k, v = (t.to(cuda) for t in _torch([q, k, v], dtype))
    if bshd:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    kw = dict(causal=causal, window=window, logit_cap=cap, q_offset=q_offset)
    before = flash_attention.launches
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _, elem, row = flash_error(out, q, k, v, **kw)
    assert elem <= 1.0 and row <= 1.0, (elem, row)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d,offset", [(8192, 2048, 0.0), (8, 2048, 0.0),
                                           (8192, 1024, 0.0), (8, 4096, 0.0),
                                           (37, 1001, 1.0)])
def test_rmsnorm_kernel_on_card(cuda, dtype, rows, d, offset):
    x, w = _normal(9, (rows, d), (d,))
    x, w = (t.to(cuda) for t in _torch([x, 1.0 + 0.1 * w], dtype))
    before = rmsnorm.launches
    out = rmsnorm(x, w, offset=offset)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    # the tolerance is the rmsnorm ref.RTOL, relative to each element
    _, elem = rmsnorm_error(out, x, w, offset=offset)
    assert elem <= 1.0, elem


@pytest.mark.cuda
def test_a_graph_capture_is_not_a_counted_launch(cuda):
    """A call captured into a CUDA graph records K2 and is not counted, and
    the graph's replays launch it without the wrapper; the replay's output
    is the eager call's."""
    x, w = _normal(9, (64, 2048), (2048,))
    x, w = (t.to(cuda) for t in _torch([x, 1.0 + 0.1 * w], torch.float32))
    want = rmsnorm(x, w)
    before = rmsnorm.launches
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = rmsnorm(x, w)
    graph.replay()
    torch.cuda.synchronize()
    assert rmsnorm.launches == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk,strided,init", [
    (2, 512, 8, 64, 1, 128, 256, False, False),
    (2, 512, 8, 64, 1, 128, 256, True, True),
    (1, 256, 8, 64, 2, 32, 64, True, False),
    (2, 384, 4, 32, 1, 64, 128, False, True),
    # L = 192 (three i tiles), and 16 chunks of recurrence
    (1, 768, 4, 64, 1, 128, 192, True, True),
    (1, 1024, 2, 32, 1, 32, 64, False, True),
])
def test_ssd_kernel_on_card(cuda, dtype, b, s, h, p, g, n, chunk, strided,
                            init):
    # the whole scan, one launch: y and the final state against the plain
    # scan.  strided: x, B and C as column slices of one [B, S, H*P + 2*G*N]
    # tensor, as mamba2_forward passes them; the tolerances are
    # ref.RTOL, ROW_RTOL and STATE_ROW_RTOL
    x, dt, a, bi, ci, st0 = _ssd_inputs(20, b, s, h, p, g, n)
    if strided:
        xbc = np.concatenate([x.reshape(b, s, -1), bi.reshape(b, s, -1),
                              ci.reshape(b, s, -1)], axis=-1)
        xbc = _torch([xbc], dtype)[0].to(cuda)
        tx, tbi, tci = torch.split(xbc, [h * p, g * n, g * n], dim=-1)
        tx = tx.reshape(b, s, h, p)
        tbi, tci = tbi.reshape(b, s, g, n), tci.reshape(b, s, g, n)
    else:
        tx, tbi, tci = (t.to(cuda) for t in _torch([x, bi, ci], dtype))
    tdt, ta, tst0 = (t.to(cuda) for t in _torch([dt, a, st0]))
    tst0 = tst0 if init else None
    before = ssd_scan.launches
    y, final = ssd_scan(tx, tdt, ta, tbi, tci, chunk=chunk,
                        initial_state=tst0)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    _, elem, row = ssd_error(y, final, tx, tdt, ta, tbi, tci, chunk, tst0)
    assert elem <= 1.0 and row <= 1.0, (elem, row)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [32, 96, 320])
def test_ssd_kernel_refuses_chunks_it_does_not_take(cuda, chunk):
    # K3 takes a chunk length that is a multiple of 64 up to 256
    x, dt, a, bi, ci, _ = _torch(_ssd_inputs(21, 1, 960, 2, 32, 1, 32))
    x, bi, ci = (t.to(cuda).bfloat16() for t in (x, bi, ci))
    with pytest.raises(ValueError):
        ssd_scan(x, dt.to(cuda), a.to(cuda), bi, ci, chunk=chunk)


# --------------------------------------------------------------------------
# the training slice: K1's log-sum-exp, K1b, K2b and gradients through them
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window,cap,q_offset", [
    (2, 8, 2, 256, 256, 64, True, 0, 0.0, 0),
    (1, 8, 2, 200, 200, 32, True, 48, 0.0, 0),
    (1, 8, 2, 100, 356, 128, True, 0, 1.0, 256),
    (2, 4, 2, 130, 70, 64, False, 0, 0.0, 0),
    (1, 16, 2, 129, 300, 64, True, 0, 0.0, 171),
    (1, 4, 2, 64, 64, 64, True, 8, 0.0, 100),   # no query sees a key
    # GQA group 4, Sq and Skv not multiples of the bf16 kernels' 128-key
    # and 128-row items: the ragged edge of both, causal and not
    (2, 16, 4, 333, 461, 64, True, 0, 0.0, 128),
    (1, 8, 2, 200, 190, 128, False, 0, 0.0, 0),
    # the families' D = 128 with a window and gemma2's cap of 50, in GQA
    # groups of 2 and 6 (mixtral's)
    (1, 8, 4, 700, 700, 128, True, 256, 50.0, 0),
    (1, 12, 2, 520, 520, 128, True, 100, 0.0, 0),
    # stablelm-12b's head_dim 160 (five 32-column blocks; 16 query rows a
    # dK/dV step) and zamba2-2.7b's 80 (padded to 96 in shared memory),
    # ragged, with an offset, a window, a cap and no causal mask
    (1, 8, 2, 333, 461, 160, True, 0, 0.0, 128),
    (1, 4, 1, 300, 300, 160, True, 64, 30.0, 0),
    (2, 4, 4, 257, 257, 80, True, 0, 0.0, 0),
    (1, 8, 2, 130, 200, 80, False, 0, 1.0, 0),
])
def test_flash_bwd_kernel_on_card(cuda, dtype, b, hq, hkv, sq, skv, d, causal,
                                  window, cap, q_offset):
    # K1 with and without lse (the output bit-identical), then K1b on K1's
    # lse; the tolerances are ref.LSE_ATOL, BWD_RTOL and BWD_ROW_RTOL
    q, k, v = (t.to(cuda) for t in _torch(_qkv(10, b, hq, hkv, sq, skv, d),
                                          dtype))
    do = _torch(_normal(11, (b, hq, sq, d)), dtype)[0].to(cuda)
    kw = dict(causal=causal, window=window, logit_cap=cap, q_offset=q_offset)
    o_null, none = k1_ops._forward(q, k, v, with_lse=False, **kw)
    o, lse = k1_ops._forward(q, k, v, with_lse=True, **kw)
    before = flash_attention_bwd.launches
    grads = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert none is None and torch.equal(o_null, o)
    assert flash_attention_bwd.launches == before + 1
    assert lse_error(lse, q, k, v, **kw)[1] <= 1.0
    for dx, x in zip(grads, (q, k, v)):
        assert dx.shape == x.shape and dx.dtype == x.dtype
    for err, elem, row in k1b_error(grads, q, k, v, o, lse, do, **kw):
        assert elem <= 1.0 and row <= 1.0, (elem, row)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d,offset", [(8192, 2048, 0.0), (8, 2048, 0.0),
                                           (4096, 1024, 1.0), (8, 4096, 0.0),
                                           (37, 1001, 1.0)])
def test_rmsnorm_bwd_kernel_on_card(cuda, dtype, rows, d, offset):
    x, w, dy = _normal(12, (rows, d), (d,), (rows, d))
    x, w, dy = (t.to(cuda) for t in _torch([x, 1.0 + 0.1 * w, dy], dtype))
    before = rmsnorm_bwd.launches
    dx, dw = rmsnorm_bwd(x, w, dy, offset=offset)
    torch.cuda.synchronize()
    assert rmsnorm_bwd.launches == before + 1
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    # the tolerances are the rmsnorm ref.BWD_RTOL, BWD_ROW_RTOL and DW_RTOL
    _, rx, rrow, _, rw = k2b_error(dx, dw, x, w, dy, offset=offset)
    assert max(rx, rrow, rw) <= 1.0, (rx, rrow, rw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_are_deterministic(cuda, dtype):
    # K1b and K2b add every sum in a fixed order (no atomics): two launches
    # on the same inputs give the same bits
    q, k, v = (t.to(cuda) for t in _torch(_qkv(15, 2, 16, 4, 700, 700, 64),
                                          dtype))
    do = _torch(_normal(16, (2, 16, 700, 64)), dtype)[0].to(cuda)
    o, lse = k1_ops._forward(q, k, v, causal=True, window=0, logit_cap=0.0,
                             q_offset=0, with_lse=True)
    first, second = (flash_attention_bwd(q, k, v, o, lse, do)
                     for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    x, w, dy = _normal(17, (4096, 2048), (2048,), (4096, 2048))
    x, w, dy = (t.to(cuda) for t in _torch([x, 1.0 + 0.1 * w, dy], dtype))
    first, second = (rmsnorm_bwd(x, w, dy) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [48, 96])
def test_flash_bwd_kernel_refuses_the_widths_it_does_not_take(cuda, d):
    # K1b takes K1's head widths (32, 64, 80, 128, 160) and raises on others
    q, k, v = (t.to(cuda, torch.bfloat16)
               for t in _torch(_qkv(3, 1, 2, 2, 64, 64, d)))
    lse = torch.zeros(1, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="widths must be one of"):
        flash_attention_bwd(q, k, v, q, lse, torch.ones_like(q))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,causal,q_offset,bshd", [
    # MLA's pair, d 192 (three 64-column blocks) and dv 128: strided as
    # mla_forward passes it, ragged across 128-row items and 64-key tiles
    # with an offset; no causal mask; GQA groups; one query row
    (1, 8, 8, 1000, 1111, True, 111, True),
    (1, 16, 16, 520, 520, True, 0, True),
    (2, 4, 2, 300, 333, False, 0, False),
    (1, 8, 2, 256, 256, True, 0, False),
    (1, 4, 4, 1, 300, True, 299, False),
])
def test_flash_kernel_at_mla_widths_on_card(cuda, dtype, b, hq, hkv, sq, skv,
                                            causal, q_offset, bshd):
    # the output is as wide as V; the tolerances are ref.RTOL and
    # ref.ROW_RTOL, and the lse the training path asks for is held too
    q, k, v = _normal(30, (b, hq, sq, 192), (b, hkv, skv, 192),
                      (b, hkv, skv, 128))
    if bshd:
        q, k, v = (np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                   for a in (q, k, v))
    q, k, v = (t.to(cuda) for t in _torch([q, k, v], dtype))
    if bshd:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    kw = dict(causal=causal, q_offset=q_offset)
    before = flash_attention.launches
    out = flash_attention(q, k, v, **kw)
    out_lse, lse = k1_ops._forward(q, k, v, with_lse=True, window=0,
                                   logit_cap=0.0, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert out.shape == (b, hq, sq, 128) and torch.equal(out, out_lse)
    _, elem, row = flash_error(out, q, k, v, **kw)
    assert elem <= 1.0 and row <= 1.0, (elem, row)
    assert lse_error(lse, q, k, v, **kw)[1] <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,causal,q_offset,bshd", [
    # K1b at MLA's pair (q and k 192 wide, v, o and dO 128): strided as
    # mla_forward passes it, ragged across the 128-key items and 64-key dQ
    # steps with an offset; GQA group 2; no causal mask
    (1, 8, 8, 1000, 1111, True, 111, True),
    (1, 8, 4, 333, 461, True, 128, False),
    (2, 4, 4, 300, 333, False, 0, True),
])
def test_flash_bwd_kernel_at_mla_widths_on_card(cuda, dtype, b, hq, hkv, sq,
                                                skv, causal, q_offset, bshd):
    # against the plain backward in double (ref.BWD_RTOL, BWD_ROW_RTOL), two
    # launches to equal bits, and autograd through flash_attention on K1b
    q, k, v, do = _normal(31, (b, hq, sq, 192), (b, hkv, skv, 192),
                          (b, hkv, skv, 128), (b, hq, sq, 128))
    if bshd:
        q, k, v = (np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                   for a in (q, k, v))
    q, k, v, do = (t.to(cuda) for t in _torch([q, k, v, do], dtype))
    if bshd:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    kw = dict(causal=causal, window=0, logit_cap=0.0, q_offset=q_offset)
    o, lse = k1_ops._forward(q, k, v, with_lse=True, **kw)
    before = flash_attention_bwd.launches
    grads = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    for dx, x in zip(grads, (q, k, v)):
        assert dx.shape == x.shape and dx.dtype == x.dtype
    for err, elem, row in k1b_error(grads, q, k, v, o, lse, do, **kw):
        assert elem <= 1.0 and row <= 1.0, (elem, row)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    auto = torch.autograd.grad(flash_attention(*leaves, causal=causal,
                                               q_offset=q_offset), leaves, do)
    assert flash_attention_bwd.launches == before + 3
    assert all(torch.equal(x, y) for x, y in zip(auto, grads))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_on_mla_latent_rows(cuda, dtype):
    # kv_norm's rows as mla_forward passes them: the first 512 columns of
    # each 576-wide [rank + rope] row, copied out contiguous; the strided
    # view itself is refused, not normed by a plain fallback; q_norm at 1536
    x, wq = _normal(31, (2, 300, 576 + 1536), (1536,))
    proj = _torch([x], dtype)[0].to(cuda)
    wkv = (1.0 + 0.1 * torch.randn(512, device=cuda)).to(dtype)
    wq = (1.0 + 0.1 * _torch([wq], dtype)[0]).to(cuda)
    latent = proj[..., :576]
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm(latent[..., :512], wkv)
    ckv = latent[..., :512].contiguous()
    cq = proj[..., 576:].contiguous()
    before = rmsnorm.launches
    out_kv, out_q = rmsnorm(ckv, wkv), rmsnorm(cq, wq)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 2
    for out, x, w in ((out_kv, ckv, wkv), (out_q, cq, wq)):
        _, elem = rmsnorm_error(out, x, w)
        assert elem <= 1.0, elem


def _tiny_mla():
    """deepseek-v3's smoke config at the published attention widths (qk
    128 + 64, v 128; two heads) with its sigmoid-gated MoE."""
    from repro_torch.configs.base import MLAConfig
    return get_smoke_config("deepseek-v3-671b").scaled(
        num_heads=2, num_kv_heads=2, dtype="bfloat16",
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128))


@pytest.mark.cuda
def test_mla_serves_through_k1_and_k2(cuda, monkeypatch):
    # bf16 prefill through K1 at (192, 128) and K2 (ln1, q_norm, kv_norm,
    # ln2 a layer, and the final norm) against the plain bf16 path, both
    # against an f32 plain run: the kernels' distance within twice the
    # plain path's.  A prefill launches K1 once a layer and K2 4 L + 1
    # times; a decode step (the absorbed form over the compressed cache)
    # K2 as often and no K1
    cfg = _tiny_mla()
    params = init_params(model_specs(cfg),
                         torch.Generator(cuda).manual_seed(4), cuda)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(17).integers(
        0, cfg.vocab_size, (2, 192)).astype(np.int32)).to(cuda)}
    counters = (flash_attention, rmsnorm)
    before = [f.launches for f in counters]
    logits = prefill(cfg, params, batch)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(counters, before)] == [2, 9]
    cache = init_params(init_cache_specs(cfg, 2, 8),
                        torch.Generator(cuda), cuda)
    assert set(cache) == {"index", "ckv"}
    before = [f.launches for f in counters]
    decode_step(cfg, params, cache, {"tokens": batch["tokens"][:, :1]})
    assert [f.launches - n for f, n in zip(counters, before)] == [0, 9]
    assert cache["ckv"][:, :, 0].abs().sum() > 0
    assert cache["ckv"][:, :, 1:].abs().sum() == 0
    plain = cfg.scaled(attn_impl="chunked")
    monkeypatch.setattr(model_common, "rmsnorm", rmsnorm_ref)
    lp = prefill(plain, params, batch)
    l32 = prefill(plain.scaled(dtype="float32"),
                  tree_map(lambda t: t.float(), params), batch)
    assert torch.isfinite(logits).all()
    dk = (logits - l32).norm() / l32.norm()
    dp = (lp - l32).norm() / l32.norm()
    assert dk <= 2 * dp, (dk.item(), dp.item())


@pytest.mark.cuda
def test_mla_donated_adafactor_step_on_the_card(cuda, monkeypatch):
    # the train step deepseek-v3-671b takes on the card, on the small MLA
    # model: K1 and K1b at (192, 128), K2 and K2b 4 L + 1 times a step, and
    # Adafactor (factored at 16, a leaf's slices of at most 8192 elements)
    # written in place, equal bit for bit to the functional step over two
    # steps, with a falling loss on a repeated batch
    from repro_torch.train import loop, optimizer
    monkeypatch.setattr(optimizer, "SLICE_ELEMENTS", 8192)
    cfg = _tiny_mla()
    opt_cfg = optimizer.OptimizerConfig(name="adafactor", warmup_steps=1,
                                        min_dim_size_to_factor=16)
    params = init_params(model_specs(cfg),
                         torch.Generator(cuda).manual_seed(5), cuda)
    state = optimizer.adafactor_init(params, opt_cfg)
    p1, s1 = tree_map(torch.clone, [params, state])
    toks = torch.from_numpy(np.random.default_rng(18).integers(
        0, cfg.vocab_size, (2, 129)).astype(np.int32)).to(cuda)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    plain = loop.make_train_step(cfg, opt_cfg)
    donated = loop.make_train_step(cfg, opt_cfg, donate=True)
    counters = (flash_attention, flash_attention_bwd, rmsnorm, rmsnorm_bwd)
    losses = []
    for _ in range(2):
        p1, s1, m1 = plain(p1, s1, batch)
        before = [f.launches for f in counters]
        leaves = tree_leaves([params, state])
        params, state, m2 = donated(params, state, batch)
        torch.cuda.synchronize()
        n = cfg.num_layers
        assert [f.launches - c for f, c in zip(counters, before)] == [
            n, n, 4 * n + 1, 4 * n + 1]
        assert all(a is b for a, b in zip(tree_leaves([params, state]),
                                          leaves))
        assert float(m1["loss"]) == float(m2["loss"])
        losses.append(float(m2["loss"]))
    for a, b in zip(tree_leaves([p1, s1]), tree_leaves([params, state])):
        assert torch.equal(a, b)
    assert np.isfinite(losses).all() and losses[1] < losses[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,offset", [(2560, 0.0), (4608, 1.0)])
def test_rmsnorm_bwd_group_widths_on_card(cuda, dtype, d, offset):
    # K2b's groups kernel at row widths whose d / 16 threads (bf16) do not
    # divide its 512: zamba2-2.7b's 2560 (three groups of 160 threads a
    # block) and gemma2-27b's 4608 with its (1 + w) (one group of 288); the
    # tolerances of the rmsnorm ref, and two launches to equal bits
    x, w, dy = _normal(18, (2048, d), (d,), (2048, d))
    x, w, dy = (t.to(cuda) for t in _torch([x, 1.0 + 0.1 * w, dy], dtype))
    dx, dw = rmsnorm_bwd(x, w, dy, offset=offset)
    again = rmsnorm_bwd(x, w, dy, offset=offset)
    torch.cuda.synchronize()
    _, rx, rrow, _, rw = k2b_error(dx, dw, x, w, dy, offset=offset)
    assert max(rx, rrow, rw) <= 1.0, (rx, rrow, rw)
    assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])


# the split-row K2 and K2b: (rows, whole row, block, the block's index) at
# a model rank's gated norm (mamba2-370m's 2048 and zamba2-2.7b's 5120 over
# 16 ranks), and a ragged block of an odd row
SPLIT_ROWS = [(4096, 2048, 128, 5), (4096, 5120, 320, 15), (37, 1001, 143, 3)]


def _split_inputs(seed, rows, whole, dtype, cuda):
    x, w, dy = _normal(seed, (rows, whole), (whole,), (rows, whole))
    return [t.to(cuda) for t in _torch([x, 1.0 + 0.1 * w, dy], dtype)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,whole,d,index", SPLIT_ROWS)
@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rmsnorm_split_row_kernels_on_card(cuda, dtype, rows, whole, d,
                                           index, offset):
    # each of the four kernels on a block of the whole rows: the row sums
    # against the plain version's over the block (an f32 sum of d terms in
    # another order: within d 2^-24 of the sum of their magnitudes), and
    # the norm and its gradients, from each row's sums over the whole row,
    # against the whole rows' plain forward and backward at the block's
    # columns with K2's and K2b's tolerances; one launch each, and the
    # backward twice to equal bits
    x, w, dy = _split_inputs(20, rows, whole, dtype, cuda)
    cols = slice(index * d, (index + 1) * d)
    xb, wb, gb = (t[..., cols].contiguous() for t in (x, w, dy))
    fns = (k2_ops.rmsnorm_sumsq, k2_ops.rmsnorm_split, k2_ops.rmsnorm_bwd_dot,
           k2_ops.rmsnorm_bwd_split)
    before = [f.launches for f in fns]
    sumsq = k2_ops.rmsnorm_sumsq(xb)
    dot = k2_ops.rmsnorm_bwd_dot(xb, wb, gb, offset)
    total = k2_ref.rmsnorm_sumsq_ref(x)
    dot_whole = k2_ref.rmsnorm_bwd_dot_ref(x, w, dy, offset)
    y = k2_ops.rmsnorm_split(xb, wb, total, 1e-5, offset, whole)
    dx, dw = k2_ops.rmsnorm_bwd_split(xb, wb, gb, total, dot_whole, 1e-5,
                                      offset, whole)
    again = k2_ops.rmsnorm_bwd_split(xb, wb, gb, total, dot_whole, 1e-5,
                                     offset, whole)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(fns, before)] == [1, 1, 1, 2]
    xf, wf, gf = xb.float(), offset + wb.float(), gb.float()
    for got, want, mag in (
            (sumsq, k2_ref.rmsnorm_sumsq_ref(xb), (xf * xf).sum(-1)),
            (dot, k2_ref.rmsnorm_bwd_dot_ref(xb, wb, gb, offset),
             (xf * wf * gf).abs().sum(-1))):
        assert got.dtype == torch.float32 and got.shape == (rows,)
        assert ((got - want).abs() <= d * 2.0 ** -24 * mag).all()
    _, elem = rmsnorm_error(y, x, w, offset=offset, cols=cols)
    assert elem <= 1.0, elem
    _, rx, rrow, _, rw = k2b_error(dx, dw, x, w, dy, offset=offset,
                                   cols=cols)
    assert max(rx, rrow, rw) <= 1.0, (rx, rrow, rw)
    assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_row_norm_autograd_on_card(cuda, dtype):
    # rmsnorm_split_row on a block of 320 of rows of 5120, the other
    # blocks' row sums added by the reduce (the model ranks' all-reduce):
    # its output and the gradients of the block of x and of w against
    # rmsnorm's (K2 and K2b) over the whole rows, at the block's columns
    rows, whole, d, index = 4096, 5120, 320, 7
    x, w, dy = _split_inputs(21, rows, whole, dtype, cuda)
    cols = slice(index * d, (index + 1) * d)
    others = torch.ones(whole, dtype=torch.bool, device=cuda)
    others[cols] = False
    xr, wr = (t.detach().requires_grad_(True) for t in (x, w))
    ref = rmsnorm(xr, wr)
    ref_dx, ref_dw = torch.autograd.grad(ref, (xr, wr), dy)
    xb, wb = (t[..., cols].contiguous().requires_grad_(True) for t in (x, w))
    passes = []

    def reduce(sums):
        # forward the other blocks' sums of squares, backward their sums of
        # x w dy
        rest = (k2_ref.rmsnorm_sumsq_ref(x[:, others]) if not passes else
                k2_ref.rmsnorm_bwd_dot_ref(x[:, others], w[others],
                                           dy[:, others], 0.0))
        passes.append(1)
        return sums + rest
    y = k2_ops.rmsnorm_split_row(xb, wb, 1e-5, 0.0, whole, reduce)
    dx, dw = torch.autograd.grad(y, (xb, wb), dy[:, cols].contiguous())
    torch.cuda.synchronize()
    assert len(passes) == 2
    tol = k2_ref.RTOL[dtype]
    for got, want in ((y, ref[:, cols]), (dx, ref_dx[:, cols]),
                      (dw, ref_dw[cols])):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 4 * tol * want.float().abs().max().item(), err


def _tiny_llama():
    # head_dim 64 (K1 takes 32, 64 and 128), GQA group 2, 2 layers
    return get_smoke_config("llama3-1b").scaled(
        d_model=256, num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=512)


@pytest.mark.cuda
def test_gradients_through_the_kernels_reach_every_parameter(cuda,
                                                             monkeypatch):
    # bf16 gradients through K1, K1b, K2 and K2b against the plain bf16 path
    # (chunked attention, plain norms), both against an f32 plain run: the
    # kernels' distance within twice the plain path's, for every parameter
    cfg = _tiny_llama()
    params = init_params(model_specs(cfg), torch.Generator(cuda).manual_seed(0),
                         cuda)
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (2, 257)).astype(np.int32)).to(cuda)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    counts = (flash_attention_bwd.launches, rmsnorm_bwd.launches)
    _, gk = _value_and_grad(cfg, params, batch)
    assert (flash_attention_bwd.launches - counts[0],
            rmsnorm_bwd.launches - counts[1]) == (2, 5)
    plain = cfg.scaled(attn_impl="chunked", attn_chunk=128)
    monkeypatch.setattr(model_common, "rmsnorm", rmsnorm_ref)
    _, gp = _value_and_grad(plain, params, batch)
    _, g32 = _value_and_grad(plain.scaled(dtype="float32"),
                             tree_map(lambda t: t.float(), params), batch)
    for (name, a), p, ref in zip(_flatten(gk).items(), tree_leaves(gp),
                                 tree_leaves(g32)):
        assert torch.isfinite(a).all() and a.abs().max() > 0, name
        dk = (a.float() - ref).norm() / ref.norm()
        dp = (p.float() - ref).norm() / ref.norm()
        assert dk <= 2 * dp, (name, dk.item(), dp.item())


@pytest.mark.cuda
def test_remat_full_recomputes_the_kernels_and_keeps_the_gradients(cuda):
    # remat="full" recomputes each layer in the backward: K1 and K2 launch
    # again there, and the gradients are bit for bit those without remat
    # (every kernel of the path is deterministic: no atomics)
    cfg = _tiny_llama()
    params = init_params(model_specs(cfg), torch.Generator(cuda).manual_seed(1),
                         cuda)
    toks = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab_size, (2, 129)).astype(np.int32)).to(cuda)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    grads, launches = [], []
    for remat in ("none", "full"):
        before = flash_attention.launches
        grads.append(_value_and_grad(cfg.scaled(remat=remat), params,
                                     batch)[1])
        launches.append(flash_attention.launches - before)
    assert launches == [cfg.num_layers, 2 * cfg.num_layers]
    for a, b in zip(tree_leaves(grads[0]), tree_leaves(grads[1])):
        assert torch.equal(a, b)


def _tiny_hybrid():
    # zamba2-2.7b's head width (2 heads of 80) and SSM widths (head_dim 64,
    # d_state 64, one group), two super-blocks of two Mamba2 layers, 64-token
    # SSD chunks
    cfg = get_smoke_config("zamba2-2.7b")
    return cfg.scaled(d_model=160, num_heads=2, num_kv_heads=2, d_ff=320,
                      vocab_size=512, ssm=dataclasses.replace(
                          cfg.ssm, head_dim=64, d_state=64, chunk_size=64))


@pytest.mark.cuda
def test_hybrid_serves_through_k1_k2_and_k3(cuda, monkeypatch):
    # bf16 prefill through K1 (head_dim 80), K2 and K3 against the plain
    # bf16 path (chunked attention and scan, plain norms), both against an
    # f32 plain run: the kernels' distance within twice the plain path's.
    # A prefill launches K1 once a super-block, K3 once a Mamba2 layer and
    # K2 2 L + 2 n_super + 1 times; a decode step K2 as often and neither
    # K1 nor K3
    cfg = _tiny_hybrid()
    params = init_params(model_specs(cfg), torch.Generator(cuda).manual_seed(2),
                         cuda)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab_size, (2, 192)).astype(np.int32)).to(cuda)}
    counters = (flash_attention, ssd_scan, rmsnorm)
    before = [f.launches for f in counters]
    logits = prefill(cfg, params, batch)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(counters, before)] == [2, 4, 13]
    cache = init_params(init_cache_specs(cfg, 2, 8),
                        torch.Generator(cuda), cuda)
    before = [f.launches for f in counters]
    decode_step(cfg, params, cache, {"tokens": batch["tokens"][:, :1]})
    assert [f.launches - n for f, n in zip(counters, before)] == [0, 0, 13]
    plain = cfg.scaled(attn_impl="chunked")
    monkeypatch.setattr(model_common, "rmsnorm", rmsnorm_ref)
    lp = prefill(plain, params, batch)
    l32 = prefill(plain.scaled(dtype="float32"),
                  tree_map(lambda t: t.float(), params), batch)
    assert torch.isfinite(logits).all()
    dk = (logits - l32).norm() / l32.norm()
    dp = (lp - l32).norm() / l32.norm()
    assert dk <= 2 * dp, (dk.item(), dp.item())


@pytest.mark.cuda
def test_hybrid_remat_full_keeps_the_gradients_on_the_card(cuda):
    # zamba2's super-block at its head width (K1 and K1b at 80, K3 and K3b,
    # K2 and K2b) under remat="full": each super-block's forward runs again
    # in the backward, so K1, K3 and K2 launch twice as often, and the
    # gradients are bit for bit those without remat (the kernels add in a
    # fixed order), the shared block's the sum over its two uses
    cfg = _tiny_hybrid()
    params = init_params(model_specs(cfg), torch.Generator(cuda).manual_seed(3),
                         cuda)
    toks = torch.from_numpy(np.random.default_rng(16).integers(
        0, cfg.vocab_size, (2, 129)).astype(np.int32)).to(cuda)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    counters = (flash_attention, ssd_scan, rmsnorm, flash_attention_bwd,
                ssd_scan_bwd, rmsnorm_bwd)
    grads, launches = [], []
    for remat in ("none", "full"):
        before = [f.launches for f in counters]
        grads.append(_value_and_grad(cfg.scaled(remat=remat), params,
                                     batch)[1])
        launches.append([f.launches - n for f, n in zip(counters, before)])
    assert launches == [[2, 4, 13, 2, 4, 13], [4, 8, 25, 2, 4, 13]]
    for (name, a), b in zip(_flatten(grads[0]).items(),
                            tree_leaves(grads[1])):
        assert torch.isfinite(a).all() and a.abs().max() > 0, name
        assert torch.equal(a, b), name


def _ssd_on_card(cuda, dtype, b, s, h, p, g, n, strided, seed=20):
    """x, dt, a, B, C and the initial state on the card; strided: x, B and
    C as column slices of one [B, S, H*P + 2*G*N] tensor, as
    mamba2_forward passes them."""
    x, dt, a, bi, ci, st0 = _ssd_inputs(seed, b, s, h, p, g, n)
    if strided:
        xbc = np.concatenate([x.reshape(b, s, -1), bi.reshape(b, s, -1),
                              ci.reshape(b, s, -1)], axis=-1)
        xbc = _torch([xbc], dtype)[0].to(cuda)
        tx, tbi, tci = torch.split(xbc, [h * p, g * n, g * n], dim=-1)
        tx = tx.reshape(b, s, h, p)
        tbi, tci = tbi.reshape(b, s, g, n), tci.reshape(b, s, g, n)
    else:
        tx, tbi, tci = (t.to(cuda) for t in _torch([x, bi, ci], dtype))
    tdt, ta, tst0 = (t.to(cuda) for t in _torch([dt, a, st0]))
    return tx, tdt, ta, tbi, tci, tst0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk,strided,init,dfin", [
    (2, 512, 8, 64, 1, 128, 256, True, False, False),
    (2, 512, 8, 64, 1, 128, 256, False, True, True),
    (1, 256, 8, 64, 2, 32, 64, True, True, True),
    (2, 384, 4, 32, 1, 64, 128, False, False, True),
    # L = 192 (three tiles), 4 heads of a group of 4
    (1, 768, 4, 64, 1, 128, 192, True, True, False),
    # the bf16 kernels' other instantiations and head groups: 1 head a
    # group (no cluster), 2 (a cluster of 2), 32 (clusters of 8)
    (1, 512, 4, 64, 4, 64, 128, True, True, True),
    (1, 384, 4, 32, 2, 128, 192, True, False, True),
    (1, 512, 32, 64, 1, 128, 256, True, True, True),
    (1, 512, 2, 32, 2, 32, 256, False, True, False),
    (2, 256, 6, 64, 3, 64, 64, True, False, True),
])
def test_ssd_bwd_kernel_on_card(cuda, dtype, b, s, h, p, g, n, chunk,
                                strided, init, dfin):
    # K3 writing each chunk's inbound state (held as its final state is),
    # then K3b on them against the plain backward in double: the tolerance
    # is ref.BWD_RTOL; a second launch gives the same bits (no atomics)
    args = _ssd_on_card(cuda, dtype, b, s, h, p, g, n, strided)
    tst0 = args[5] if init else None
    args = args[:5]
    y, final, states = k3_ops._launch(*args, chunk, tst0, with_states=True)
    assert ssd_error(y, final, *args, chunk, tst0, states)[1] <= 1.0
    dy = _torch(_normal(21, (b, s, h, p)), dtype)[0].to(cuda)
    dfinal = (_torch(_normal(22, (b, h, p, n)))[0].to(cuda) if dfin
              else None)
    kw = dict(chunk=chunk, initial_state=tst0, dfinal=dfinal)
    before = ssd_scan_bwd.launches
    grads = ssd_scan_bwd(*args, states, dy, **kw)
    torch.cuda.synchronize()
    assert ssd_scan_bwd.launches == before + 1
    for gr, ref in zip(grads, (args[0], args[1], args[2], args[3], args[4])):
        assert gr.shape == ref.shape
    for err, elem, row in k3b_error(grads, *args, chunk, tst0, dy, dfinal):
        assert elem <= 1.0 and row <= 1.0, (elem, row)
    again = ssd_scan_bwd(*args, states, dy, **kw)
    assert all(torch.equal(u, v) for u, v in zip(grads, again))


@pytest.mark.cuda
def test_ssd_bwd_kernel_gives_equal_bits_at_zamba2s_shape(cuda):
    # zamba2-2.7b's train shape (80 heads, P 64, N 64, 256-row chunks):
    # forty launches of K3b on one input give the same bits.  Before its
    # chunk kernel fenced the anchor's loads of x before freeing it, about
    # one launch in seven wrote a few wrong rows of ddt here
    x, dt, a, bi, ci, _ = _ssd_on_card(cuda, torch.bfloat16, 2, 4096, 80, 64,
                                       1, 64, True, seed=23)
    _, _, states = k3_ops._launch(x, dt, a, bi, ci, 256, None,
                                  with_states=True)
    dy = _torch(_normal(24, (2, 4096, 80, 64)), torch.bfloat16)[0].to(cuda)
    first = ssd_scan_bwd(x, dt, a, bi, ci, states, dy, chunk=256)
    for _ in range(40):
        again = ssd_scan_bwd(x, dt, a, bi, ci, states, dy, chunk=256)
        assert all(torch.equal(u, v) for u, v in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_trains_through_k3_and_k3b_on_the_card(cuda, dtype):
    # under grad the scan is one launch of K3 (writing its states) and its
    # gradients one of K3b, which agree with the plain backward
    args = list(_ssd_on_card(cuda, dtype, 1, 512, 4, 64, 1, 128, True, 23))
    leaves = [t.detach().requires_grad_(True) for t in args]
    k3, k3b = ssd_scan.launches, ssd_scan_bwd.launches
    y, final = ssd_scan(*leaves[:5], chunk=128, initial_state=leaves[5])
    dy = _torch(_normal(24, tuple(y.shape)), dtype)[0].to(cuda)
    grads = torch.autograd.grad((y, final), leaves, (dy, torch.ones_like(
        final)))
    torch.cuda.synchronize()
    assert (ssd_scan.launches, ssd_scan_bwd.launches) == (k3 + 1, k3b + 1)
    for err, elem, row in k3b_error(grads, *args[:5], 128, args[5], dy,
                                    torch.ones_like(final)):
        assert elem <= 1.0 and row <= 1.0, (elem, row)
    with torch.no_grad():   # no gradient asked for: K3 alone, no states
        ssd_scan(*args[:5], chunk=128)
    assert ssd_scan.launches == k3 + 2


@pytest.mark.cuda
def test_export_on_the_card_launches_nothing_and_equals_the_cpu_text(cuda):
    # a trace on fake cuda tensors runs only the operators' fakes: no
    # launch, no device memory, and the same text as on the CPU
    from repro_torch.core.pipeline import export_workload
    from repro_torch.train.loop import train_step_exports

    cfg = get_smoke_config("llama3-1b")
    step, args = train_step_exports(cfg, 128, 2)
    counters = [f.launches for f in (flash_attention, flash_attention_bwd,
                                     rmsnorm, rmsnorm_bwd, ssd_scan)]
    mem = torch.cuda.memory_allocated(cuda)
    w = export_workload(step, *args, device=cuda)
    assert torch.cuda.memory_allocated(cuda) == mem
    assert [f.launches for f in (flash_attention, flash_attention_bwd,
                                 rmsnorm, rmsnorm_bwd, ssd_scan)] == counters
    n = cfg.num_layers
    assert w.meta["kernel_ops"] == {"flash_attention_lse": n,
                                    "flash_attention_bwd": n,
                                    "rmsnorm": 2 * n + 1,
                                    "rmsnorm_bwd": 2 * n + 1}
    assert w.stablehlo_text == export_workload(
        step, *args, device="cpu").stablehlo_text


_KERNELS = (flash_attention, flash_attention_bwd, rmsnorm, rmsnorm_bwd)


@pytest.mark.cuda
def test_per_rank_step_in_a_fake_world_launches_the_four_kernels(cuda):
    # one rank of a [4, 1] data mesh, eagerly on the card: its gathers move
    # no data (the fake backend), so this counts launches only
    from repro_torch.launch.mesh import traced_mesh
    from repro_torch.models.params import shard_params
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import OptimizerConfig, adamw_init

    cfg = _tiny_llama()
    specs = model_specs(cfg)
    toks = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab_size, (1, 129)).astype(np.int32)).to(cuda)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    with traced_mesh((4, 1), cuda) as mesh:
        params = shard_params(specs, init_params(
            specs, torch.Generator(cuda).manual_seed(2), cuda), mesh)
        opt_cfg = OptimizerConfig()
        step = make_train_step(cfg, opt_cfg, mesh=mesh)
        before = [f.launches for f in _KERNELS]
        step(params, adamw_init(params, opt_cfg), batch)
        torch.cuda.synchronize()
    n = cfg.num_layers
    assert [f.launches - b for f, b in zip(_KERNELS, before)] == [
        n, n, 2 * n + 1, 2 * n + 1]


def _allocations(device) -> int:
    """The card's allocator's count of allocations so far (a free does
    not lower it)."""
    return torch.cuda.memory_stats(device).get("allocation.all.allocated", 0)


@pytest.mark.cuda
def test_mesh_export_on_the_card_allocates_nothing(cuda):
    # the [4, 1] export on fake cuda tensors: the global and the per-rank
    # traces launch nothing and allocate nothing (counted around the
    # export, inside the fake world); the per-rank text is the CPU's
    from repro_torch.core.pipeline import export_workload
    from repro_torch.launch.mesh import traced_mesh
    from repro_torch.models.registry import get_config
    from repro_torch.train.loop import train_step_exports

    cfg = get_config("llama3-100m")
    step, args = train_step_exports(cfg, 128, 4)
    texts = []
    for device in (cuda, "cpu"):
        with traced_mesh((4, 1), device) as mesh:
            rank = train_step_exports(cfg, 128, 4, mesh)
            counters = [f.launches for f in _KERNELS]
            allocs = _allocations(cuda)
            w = export_workload(step, *args, device=device,
                                per_rank=(*rank, mesh))
            assert _allocations(cuda) == allocs
            assert [f.launches for f in _KERNELS] == counters
        texts.append(w.hlo_text)
    assert "mhlo.num_partitions = 4 " in texts[0]
    assert texts[0] == texts[1]


# --------------------------------------------------------------------------
# the sparse MoE layer on the card
# --------------------------------------------------------------------------

def _moe(dtype, capacity_factor, seed=0):
    """mixtral-smoke's MoE at a width and token count where experts overflow
    their capacity: the config, its parameters and tokens [2, 256, d] as
    f32 numpy-seeded CPU tensors (router of std 1/sqrt(d), so top-k
    margins are of order 1)."""
    from dataclasses import replace

    from repro_torch.models.mlp import moe_specs
    cfg = get_smoke_config("mixtral-8x22b")
    cfg = cfg.scaled(d_model=256, dtype="float32",
                     moe=replace(cfg.moe, num_experts=8, d_ff_expert=512,
                                 capacity_factor=capacity_factor))
    rng = np.random.default_rng(seed)
    p = {k: torch.from_numpy((rng.standard_normal(s.shape)
                              / np.sqrt(s.shape[-2])).astype(np.float32))
         for k, s in moe_specs(cfg).items()}
    x = torch.from_numpy(rng.standard_normal((2, 256, 256)).astype(np.float32))
    return cfg.scaled(dtype={torch.float32: "float32",
                             torch.bfloat16: "bfloat16"}[dtype]), p, x


@pytest.mark.cuda
@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_moe_layer_on_card_matches_its_plain_path(cuda, capacity_factor):
    """The MoE layer on the card in f32 against the same layer on the CPU
    (its plain path): the same experts for every token, capacity drops
    included, and outputs within f32 rounding; in bf16 each token's row
    within 2^-6 of the f32 row where its kept experts agree (and 0 where
    every expert dropped it)."""
    from repro_torch.models.mlp import (_capacity, moe_dispatch, moe_forward,
                                        moe_route)
    cfg, p, x = _moe(torch.float32, capacity_factor)
    want = moe_forward(cfg, p, x)
    got = moe_forward(cfg, {k: v.to(cuda) for k, v in p.items()}, x.to(cuda))
    xf = x.reshape(-1, x.shape[-1])
    _, top_e = moe_route(cfg, p, xf)
    _, top_e_card = moe_route(cfg, {k: v.to(cuda) for k, v in p.items()},
                              xf.to(cuda))
    assert torch.equal(top_e_card.cpu(), top_e)
    keep = moe_dispatch(top_e, 8, _capacity(xf.shape[0], cfg.moe))[2]
    assert (not keep.all()) == (capacity_factor < 1)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    c16, _, _ = _moe(torch.bfloat16, capacity_factor)
    p16 = {k: v.to(cuda, torch.bfloat16) for k, v in p.items()}
    x16 = x.to(cuda, torch.bfloat16)
    got16 = moe_forward(c16, p16, x16).float().cpu()
    _, e16 = moe_route(c16, p16, x16.reshape(-1, x.shape[-1]))

    def experts(top_e):       # [T, E]: the experts that keep each token
        t, k = top_e.shape
        order, _, keep, _ = moe_dispatch(top_e, 8, _capacity(t, cfg.moe))
        kept = torch.empty_like(keep).scatter_(0, order, keep).view(t, k)
        return torch.zeros(t, 8, dtype=torch.bool).scatter_(1, top_e, kept)
    same = (experts(e16.cpu()) == experts(top_e)).all(-1)
    assert same.float().mean() > 0.9
    rows = same.view(x.shape[:2])
    # a token every expert dropped is 0 in both (the residual carries it)
    dropped = rows & (want.norm(dim=-1) == 0)
    assert torch.equal(got16[dropped], want[dropped])
    kept = rows & ~dropped
    err = (got16 - want)[kept].norm(dim=-1) / want[kept].norm(dim=-1)
    assert err.max() <= 2.0 ** -6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_layer_on_card_gives_equal_bits_twice(cuda, dtype):
    """The scatter-adds (``index_add``, atomics on the card) add one real
    row and zeros to a buffer row, and a token's k rows to zeros: exact in
    any order, so two runs give the same bits."""
    from repro_torch.models.mlp import moe_forward
    cfg, p, x = _moe(dtype, 0.25)
    p = {k: v.to(cuda, dtype) for k, v in p.items()}
    x = x.to(cuda, dtype)
    assert torch.equal(moe_forward(cfg, p, x), moe_forward(cfg, p, x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_layer_backward_on_card_gives_equal_bits_twice(cuda, dtype):
    """The MoE's backward: ``index_add``'s gradient is a gather, a gather's
    an accumulate of a token's k rows onto zeros (exact in either order for
    k = 2), ``topk``'s a scatter of distinct indices: two runs give the same
    bits for the input and every weight."""
    from repro_torch.models.mlp import moe_forward
    cfg, p, x = _moe(dtype, 0.25)
    leaves = [x.to(cuda, dtype).requires_grad_(True)] + [
        v.to(cuda, dtype).requires_grad_(True) for v in p.values()]
    dy = _torch(_normal(27, tuple(x.shape)), dtype)[0].to(cuda)

    def grads():
        out = moe_forward(cfg, dict(zip(p, leaves[1:])), leaves[0])
        return torch.autograd.grad(out, leaves, dy)
    first, second = grads(), grads()
    assert all(g.abs().max() > 0 for g in first)
    assert all(torch.equal(u, v) for u, v in zip(first, second))


# --------------------------------------------------------------------------
# the last two ids: qwen2-vl-7b (GQA group 7, M-RoPE) and hubert-xlarge (no
# causal mask at head_dim 80, norms at 1280)
# --------------------------------------------------------------------------

def image_streams(b: int, s: int, prefix: int, grid: int) -> np.ndarray:
    """M-RoPE's [3, B, S] int32 streams (t, h, w) as Qwen2-VL lays out one
    image: ``prefix`` text tokens at 0..prefix-1 on all three streams; a
    1 x grid x grid patch grid at (prefix, prefix + row, prefix + col);
    then text resuming at the largest position + 1 (prefix + grid) on all
    three."""
    n = grid * grid
    assert prefix + n <= s
    pos = np.empty((3, b, s), np.int32)
    pos[:, :, :prefix] = np.arange(prefix)
    row, col = np.divmod(np.arange(n), grid)
    pos[0, :, prefix:prefix + n] = prefix
    pos[1, :, prefix:prefix + n] = prefix + row
    pos[2, :, prefix:prefix + n] = prefix + col
    pos[:, :, prefix + n:] = prefix + grid + np.arange(s - prefix - n)
    return pos


def _bshd(cuda, dtype, seed, b, hq, hkv, s, d):
    """q, k, v [B, S, H, D] on the card seen as [B, H, S, D], as
    gqa_forward passes its projections, and a dO of q's layout."""
    q, k, v, do = _normal(seed, (b, s, hq, d), (b, s, hkv, d),
                          (b, s, hkv, d), (b, s, hq, d))
    return [t.to(cuda).transpose(1, 2) for t in _torch([q, k, v, do], dtype)]


# B, Hq, Hkv, S, D, causal: qwen2-vl-7b's prefill (one prompt) and train
# step (D 128, 28/4 heads: a group of 7), hubert-xlarge's (D 80, 16/16
# heads, no causal mask), at chip_smoke.py's phase-3 shapes
LAST_IDS_K1 = {"qwen2-vl": (1, 28, 4, 8192, 128, True),
               "hubert": (1, 16, 16, 8192, 80, False)}
LAST_IDS_K1B = {"qwen2-vl": (2, 28, 4, 4096, 128, True),
                "hubert": (2, 16, 16, 4096, 80, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(LAST_IDS_K1))
def test_flash_kernel_at_the_last_ids_shapes(cuda, dtype, case):
    # the tolerances are ref.RTOL, ROW_RTOL and LSE_ATOL
    b, hq, hkv, s, d, causal = LAST_IDS_K1[case]
    q, k, v, _ = _bshd(cuda, dtype, 32, b, hq, hkv, s, d)
    kw = dict(causal=causal, window=0, logit_cap=0.0, q_offset=0)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    out_lse, lse = k1_ops._forward(q, k, v, with_lse=True, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert torch.equal(out, out_lse)
    _, elem, row = flash_error(out, q, k, v, **kw)
    assert elem <= 1.0 and row <= 1.0, (elem, row)
    assert lse_error(lse, q, k, v, **kw)[1] <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(LAST_IDS_K1B))
def test_flash_bwd_kernel_at_the_last_ids_shapes(cuda, dtype, case):
    # against the plain backward in double (ref.BWD_RTOL, BWD_ROW_RTOL), a
    # KV head's group at a time; two launches to equal bits
    from repro_torch.kernels.flash_attention.ref import by_kv_head
    b, hq, hkv, s, d, causal = LAST_IDS_K1B[case]
    q, k, v, do = _bshd(cuda, dtype, 33, b, hq, hkv, s, d)
    kw = dict(causal=causal, window=0, logit_cap=0.0, q_offset=0)
    o, lse = k1_ops._forward(q, k, v, with_lse=True, **kw)
    before = flash_attention_bwd.launches
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again))
    del again
    for heads, qh, kh, vh in by_kv_head(q, k, v):
        h = heads.start // (heads.stop - heads.start)
        errs = k1b_error((dq[:, heads], dk[:, h:h + 1], dv[:, h:h + 1]), qh,
                         kh, vh, o[:, heads], lse[:, heads], do[:, heads],
                         **kw)
        for err, elem, row in errs:
            assert elem <= 1.0 and row <= 1.0, (h, elem, row)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [3584, 1280])
def test_rmsnorm_kernels_at_the_last_ids_widths(cuda, dtype, d):
    # K2 and K2b at qwen2-vl-7b's d_model (K2's block-a-row kernel; K2b's
    # groups kernel, two groups of 224 threads a block) and hubert-xlarge's
    # 1280 (K2's warp-a-row kernel; 80 threads a row, K2b's block kernel),
    # on a train step's 2 x 4096 rows; K2b twice to equal bits
    x, w, dy = _normal(34, (8192, d), (d,), (8192, d))
    x, w, dy = (t.to(cuda) for t in _torch([x, 1.0 + 0.1 * w, dy], dtype))
    before = (rmsnorm.launches, rmsnorm_bwd.launches)
    out = rmsnorm(x, w)
    dx, dw = rmsnorm_bwd(x, w, dy)
    again = rmsnorm_bwd(x, w, dy)
    torch.cuda.synchronize()
    assert (rmsnorm.launches, rmsnorm_bwd.launches) == (before[0] + 1,
                                                        before[1] + 2)
    assert rmsnorm_error(out, x, w)[1] <= 1.0
    _, rx, rrow, _, rw = k2b_error(dx, dw, x, w, dy)
    assert max(rx, rrow, rw) <= 1.0, (rx, rrow, rw)
    assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])


def _tiny_last(arch):
    """qwen2-vl-7b's smoke config at its head width and group (7 heads of
    128 over one KV head, its sections (16, 24, 24)) and hubert-xlarge's
    at its head width (2 heads of 80), two layers each."""
    if arch == "qwen2-vl-7b":
        return get_smoke_config(arch).scaled(
            d_model=896, num_heads=7, num_kv_heads=1, d_ff=512,
            vocab_size=512, mrope_sections=(16, 24, 24))
    return get_smoke_config(arch).scaled(d_model=160, num_heads=2,
                                         num_kv_heads=2, d_ff=320)


def _last_batch(cfg, cuda, b, s):
    rng = np.random.default_rng(35)
    targets = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)).to(cuda)
    if cfg.frontend == "stub":
        return {"embeds": torch.from_numpy(rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)).to(cuda),
            "targets": targets}
    return {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).to(cuda),
        "targets": targets,
        "mrope_positions": torch.from_numpy(image_streams(b, s, 16, 8)).to(
            cuda)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "hubert-xlarge"])
def test_the_last_ids_serve_and_train_through_the_kernels(cuda, arch,
                                                          monkeypatch):
    # bf16 prefill (K1 a layer, K2 2 L + 1) and gradients (K1b a layer, K2b
    # 2 L + 1) through the kernels against the plain bf16 path (chunked
    # attention, plain norms), both against an f32 plain run: the kernels'
    # distance within twice the plain path's, for the logits and every
    # parameter's gradient; qwen2-vl with one image's M-RoPE streams,
    # hubert from frame embeddings without a causal mask
    cfg = _tiny_last(arch)
    params = init_params(model_specs(cfg), torch.Generator(cuda).manual_seed(3),
                         cuda)
    batch = _last_batch(cfg, cuda, 2, 256)
    counters = (flash_attention, rmsnorm, flash_attention_bwd, rmsnorm_bwd)
    before = [f.launches for f in counters]
    logits = prefill(cfg, params, batch)
    _, gk = _value_and_grad(cfg, params, batch)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(counters, before)] == [4, 10, 2, 5]
    plain = cfg.scaled(attn_impl="chunked", attn_chunk=128)
    monkeypatch.setattr(model_common, "rmsnorm", rmsnorm_ref)
    p32 = tree_map(lambda t: t.float(), params)
    cfg32 = plain.scaled(dtype="float32")
    lp, l32 = prefill(plain, params, batch), prefill(cfg32, p32, batch)
    assert torch.isfinite(logits).all()
    dk = (logits - l32).norm() / l32.norm()
    dp = (lp - l32).norm() / l32.norm()
    assert dk <= 2 * dp, (dk.item(), dp.item())
    _, gp = _value_and_grad(plain, params, batch)
    _, g32 = _value_and_grad(cfg32, p32, batch)
    for (name, a), p, ref in zip(_flatten(gk).items(), tree_leaves(gp),
                                 tree_leaves(g32)):
        if name == "embed" and cfg.frontend == "stub":
            continue      # frame embeddings in: the table takes no gradient
        assert torch.isfinite(a).all() and a.abs().max() > 0, name
        dk = (a.float() - ref).norm() / ref.norm()
        dp = (p.float() - ref).norm() / ref.norm()
        assert dk <= 2 * dp, (name, dk.item(), dp.item())
