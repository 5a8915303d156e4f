"""The port's CUDA kernels against their plain versions on the card: K1
(flash attention), K2 (RMSNorm) and K3 (the SSD scan), each at a few shapes
and layouts of the serving paths, in f32 and bf16, with the tolerances of
each kernel's ``ref.kernel_error``.  Every test is marked ``cuda`` and skips
without a card.  The file imports neither JAX nor the JAX package, so it
also runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    kernel_error as flash_error)
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import kernel_error as rmsnorm_error
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import kernel_error as ssd_error


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
