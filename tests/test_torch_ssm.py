"""The port's SSM path (K3, ``models/ssm.py``, the SSM branches of
``models/transformer.py``) against the JAX package on the CPU in f32, with
the same parameters (``params_from_jax``) and the same inputs (numpy's seeded
generator).  JAX's Pallas SSD kernel runs in interpret mode, as
tests/test_kernels.py runs it.  K3 itself runs only on the card: it is held
against its plain version, ``ref.ssd_scan_ref``, in
tests/test_torch_cuda.py; here that plain version is held against JAX."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_chunk_pallas
from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_tf
from repro.models.params import init_params as jax_init_params
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import get_smoke_config as jax_get_smoke_config
from repro.serve.decode import greedy_decode as jax_greedy_decode
from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import ref as ssd_plain
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import (chunk_states, kernel_error,
                                              ssd_chunk_ref, ssd_ref,
                                              ssd_scan_ref)
from repro_torch.models import ssm, transformer
from repro_torch.models.params import init_params, params_from_jax
from repro_torch.models.registry import get_config, get_smoke_config
from repro_torch.serve.decode import greedy_decode

SSD_TOL = dict(atol=2e-3, rtol=2e-3)      # tests/test_kernels.py's, for K3
CHUNK_TOL = dict(atol=1e-4, rtol=1e-4)    # one chunk's sums in another order
MODULE_TOL = dict(atol=2e-5, rtol=2e-5)   # one module in f32
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)    # a whole LM in f32
# SSM states are sums of terms up to a few hundred that cancel: their
# elements are held to 1e-5 of the largest one
STATE_REL = 1e-5
JAX_IMPL = {"kernel": "pallas", "chunked": "chunked", "dense": "dense"}
# the TestSSDScan shapes: b, s, h, p, g, n, chunk
SSD_SHAPES = [(2, 128, 4, 32, 1, 16, 32), (1, 256, 8, 64, 2, 32, 64),
              (1, 64, 2, 16, 1, 8, 16)]


def _ssd_inputs(seed, b, s, h, p, g, n, init=False):
    """x, dt (softplus of a normal), a (negative), B, C[, initial state] as
    f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    bi = rng.standard_normal((b, s, g, n)).astype(np.float32)
    ci = rng.standard_normal((b, s, g, n)).astype(np.float32)
    out = [x, dt, a, bi, ci]
    if init:
        out.append(rng.standard_normal((b, h, p, n)).astype(np.float32))
    return out


def _t(arrays, dtype=torch.float32):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
            for a in arrays]


def _configs(impl="kernel", full=False, **kw):
    jget, tget = ((jax_get_config, get_config) if full
                  else (jax_get_smoke_config, get_smoke_config))
    jcfg = jget("mamba2-370m").scaled(dtype="float32",
                                      attn_impl=JAX_IMPL[impl], **kw)
    tcfg = tget("mamba2-370m").scaled(dtype="float32", attn_impl=impl, **kw)
    return jcfg, tcfg


def _params(jcfg, seed=0):
    jp = jax_init_params(jax_tf.model_specs(jcfg), jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _np_tree(tree, rng):
    """Random f32 values for a JAX spec tree (norm weights around 1, biases
    nonzero, a_log as its initializer's range), as numpy."""
    if isinstance(tree, dict):
        return {k: _np_tree(v, rng) for k, v in tree.items()}
    x = rng.standard_normal(tree.shape).astype(np.float32)
    if tree.init == "ssm_a":
        return np.log(rng.uniform(1.0, 16.0, tree.shape)).astype(np.float32)
    return 1.0 + 0.1 * x if tree.init == "ones" else 0.2 * x


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, device="cpu"))


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


# --------------------------------------------------------------------------
# K3's plain version and the scan around it
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SHAPES)
def test_ssd_chunk_ref_matches_pallas(b, s, h, p, g, n, chunk):
    # the plain version of K3's function against the TPU kernel in interpret
    # mode on the same chunked inputs, with nonzero inbound states
    x, dt, a, bi, ci = _ssd_inputs(0, b, s, h, p, g, n)
    nc = s // chunk
    states = np.random.default_rng(1).standard_normal(
        (b, nc, h, p, n)).astype(np.float32)
    dacs = np.cumsum((dt * a).reshape(b, nc, chunk, h), axis=2)
    y, out = ssd_chunk_ref(*_t([x, dt, bi, ci, dacs.reshape(b, s, h),
                                states]))
    hpg = h // g
    xc = x.reshape(b, nc, chunk, h, p)
    dtx = xc * dt.reshape(b, nc, chunk, h)[..., None]
    bh = np.repeat(bi, hpg, axis=2).reshape(b, nc, chunk, h, n)
    ch = np.repeat(ci, hpg, axis=2).reshape(b, nc, chunk, h, n)
    ry, rout = ssd_chunk_pallas(*map(jnp.asarray, (
        xc, dtx, bh, ch, dacs, dacs[:, :, -1], states)), interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry).reshape(b, s, h, p),
                               **CHUNK_TOL)
    np.testing.assert_allclose(out.numpy(), rout, **CHUNK_TOL)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SHAPES)
def test_ssd_scan_matches_jax_and_sequential_ref(b, s, h, p, g, n, chunk):
    arrays = _ssd_inputs(2, b, s, h, p, g, n)
    y, st = ssd_scan(*_t(arrays), chunk=chunk)
    jy, jst = jax_ssd_scan(*map(jnp.asarray, arrays), chunk=chunk)
    ry, rst = jax_ssd_ref(*map(jnp.asarray, arrays))
    py, pst = ssd_ref(*_t(arrays))
    for out, ref in ((y, jy), (y, ry), (py, ry), (st, jst), (st, rst),
                     (pst, rst)):
        np.testing.assert_allclose(out.numpy(), ref, **SSD_TOL)


def test_ssd_scan_initial_state_continuation():
    # two halves with the state carried == the whole, and == JAX's halves
    x, dt, a, bi, ci, st0 = _ssd_inputs(3, 1, 128, 2, 16, 1, 8, init=True)
    tx, tdt, ta, tbi, tci, tst0 = _t([x, dt, a, bi, ci, st0])
    y_full, st_full = ssd_scan(tx, tdt, ta, tbi, tci, chunk=32,
                               initial_state=tst0)
    y1, st1 = ssd_scan(tx[:, :64], tdt[:, :64], ta, tbi[:, :64],
                       tci[:, :64], chunk=32, initial_state=tst0)
    y2, st2 = ssd_scan(tx[:, 64:], tdt[:, 64:], ta, tbi[:, 64:],
                       tci[:, 64:], chunk=32, initial_state=st1)
    np.testing.assert_allclose(torch.cat([y1, y2], dim=1).numpy(),
                               y_full.numpy(), atol=2e-3)
    np.testing.assert_allclose(st2.numpy(), st_full.numpy(), atol=2e-3)
    jy, jst = jax_ssd_scan(*map(jnp.asarray, (x, dt, a, bi, ci)), chunk=32,
                           initial_state=jnp.asarray(st0))
    np.testing.assert_allclose(y_full.numpy(), jy, **SSD_TOL)
    np.testing.assert_allclose(st_full.numpy(), jst, **SSD_TOL)


def test_segment_sum_recurrence_matches_the_chunk_loop():
    # ref.chunk_states runs the inter-chunk recurrence as one [C+1, C+1]
    # segment-sum product; the plain ssd_chunked loops over the chunks
    x, dt, a, bi, ci, st0 = _t(_ssd_inputs(4, 2, 256, 4, 32, 2, 16,
                                           init=True))
    _, inbound, final = chunk_states(x, dt, a, bi, 32, st0)
    y, final_loop = ssm.ssd_chunked(x, dt, a, bi, ci, 32, st0)
    np.testing.assert_allclose(final.numpy(), final_loop.numpy(),
                               **CHUNK_TOL)
    np.testing.assert_allclose(inbound[:, 0].numpy(), st0.numpy())
    e = torch.randn(3, 9, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(ssd_plain._segsum(e).numpy(),
                               ssm._segsum(e).numpy(), atol=1e-5)


def _scan_with_fault(x, dt, a, b_in, c_in, chunk, st0, fault=None):
    """The scan chunk by chunk, as K3 walks it, with one planted fault:
    ``no_state`` (y without the inbound state's term), ``no_diag`` (the
    diagonal masked), ``no_decay`` (the state not decayed between chunks)
    or ``bf16_local`` (w x rounded to bf16 in the local state).  Returns
    (y in x.dtype, final state)."""
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    dacs = chunk_states(x, dt, a, b_in, chunk, st0)[0]
    state, ys = st0.float(), []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        inbound = torch.zeros_like(state) if fault == "no_state" else state
        y, local = ssd_chunk_ref(x[:, sl], dt[:, sl], b_in[:, sl],
                                 c_in[:, sl], dacs[:, sl], inbound[:, None])
        y = y.float()
        if fault == "no_diag":
            # the diagonal's term (C_i . B_i) dt_i x_i, left out
            cb = torch.einsum("bsgn,bsgn->bsg", c_in[:, sl].float(),
                              b_in[:, sl].float()).repeat_interleave(
                                  h // g, dim=2)
            y = y - cb[..., None] * dt[:, sl, :, None] * x[:, sl].float()
        da = dacs[:, sl]
        if fault == "bf16_local":
            w = torch.exp(da[:, -1:] - da) * dt[:, sl]
            xw = (x[:, sl].float() * w[..., None]).bfloat16().float()
            bh = b_in[:, sl].float().repeat_interleave(h // g, dim=2)
            local = torch.einsum("bthp,bthn->bhpn", xw, bh)[:, None]
        decay = 1.0 if fault == "no_decay" else torch.exp(da[:, -1])
        state = state * (decay if fault == "no_decay"
                         else decay[:, :, None, None]) + local[:, 0]
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype), state


def _bf16_case(seed):
    x, dt, a, bi, ci, st0 = _ssd_inputs(seed, 1, 512, 4, 64, 1, 32,
                                        init=True)
    tx, tbi, tci = _t([x, bi, ci], torch.bfloat16)
    tdt, ta, tst0 = _t([dt, a, st0])
    return tx, tdt, ta, tbi, tci, tst0


def test_kernel_error_flags_planted_faults():
    # the tolerance K3 is held to on the card, checked here on the CPU: the
    # plain scan in bf16, and the chunk-by-chunk walk, pass; the same without
    # the inbound state's term, or with the mask taken as i > j, fails
    tx, tdt, ta, tbi, tci, tst0 = _bf16_case(5)
    args = (tx, tdt, ta, tbi, tci, 64, tst0)
    good = ssd_scan(*args[:5], chunk=64, initial_state=tst0)
    assert good[0].dtype == torch.bfloat16
    assert max(kernel_error(*good, *args)[1:]) <= 1
    assert max(kernel_error(*_scan_with_fault(*args), *args)[1:]) <= 1
    for fault in ("no_state", "no_diag"):
        _, elem, row = kernel_error(*_scan_with_fault(*args, fault), *args)
        assert elem > 1.0 and row > 1.0, (fault, elem, row)


@pytest.mark.parametrize("fault", ["no_decay", "bf16_local"])
def test_kernel_error_flags_recurrence_faults(fault):
    # faults of the state path that K3 now computes itself: a state not
    # decayed between chunks, and a local state whose weighted x went into
    # the tensor cores rounded to bf16 (the state rows' tolerance)
    tx, tdt, ta, tbi, tci, tst0 = _bf16_case(6)
    args = (tx, tdt, ta, tbi, tci, 64, tst0)
    _, _, row = kernel_error(*_scan_with_fault(*args, fault), *args)
    assert row > 1.0, (fault, row)


def test_ssd_scan_ref_is_the_chunked_scan():
    # ssd_scan_ref is chunk_states followed by ssd_chunk_ref with the inbound
    # states; its dacs is a cumulative sum taken in double and rounded once
    x, dt, a, bi, ci, st0 = _t(_ssd_inputs(21, 2, 256, 4, 32, 2, 16,
                                           init=True))
    y, final = ssd_scan_ref(x, dt, a, bi, ci, 64, st0)
    dacs, inbound, final2 = chunk_states(x, dt, a, bi, 64, st0)
    np.testing.assert_array_equal(
        y.numpy(), ssd_chunk_ref(x, dt, bi, ci, dacs, inbound)[0].numpy())
    np.testing.assert_array_equal(final.numpy(), final2.numpy())
    exact = np.cumsum((dt * a).numpy().astype(np.float64).reshape(
        2, 4, 64, 4), axis=2).astype(np.float32).reshape(2, 256, 4)
    np.testing.assert_array_equal(dacs.numpy(), exact)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (1, 256, 4, 32, 2, 16, 64),      # L = 64 (groups2's), two groups
    (1, 1024, 2, 16, 1, 8, 64),      # 16 chunks of recurrence
    (2, 512, 4, 32, 1, 32, 128),
])
def test_ssd_scan_ref_matches_jax_with_initial_state(b, s, h, p, g, n,
                                                     chunk):
    # K3's plain version against JAX's ssd_scan (Pallas in interpret mode)
    # and the sequential oracle, with an initial state
    arrays = _ssd_inputs(22, b, s, h, p, g, n, init=True)
    st0 = arrays.pop()
    y, st = ssd_scan_ref(*_t(arrays), chunk, torch.from_numpy(st0))
    jy, jst = jax_ssd_scan(*map(jnp.asarray, arrays), chunk=chunk,
                           initial_state=jnp.asarray(st0))
    ry, rst = ssd_ref(*_t(arrays), torch.from_numpy(st0))
    for out, ref in ((y, jy), (y, ry), (st, jst), (st, rst)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **SSD_TOL)


@pytest.mark.parametrize("bad", ["seq_not_divisible", "dtype", "b_shape",
                                 "a_shape", "groups", "state_shape"])
def test_ssd_scan_refuses_bad_inputs(bad):
    x, dt, a, bi, ci, st0 = _t(_ssd_inputs(6, 1, 64, 4, 16, 2, 8, init=True))
    kw = dict(chunk=16, initial_state=st0)
    if bad == "seq_not_divisible":
        kw["chunk"] = 24
    elif bad == "dtype":
        bi = bi.to(torch.bfloat16)
    elif bad == "b_shape":
        bi = bi[:, :32]
    elif bad == "a_shape":
        a = a[:3]
    elif bad == "groups":
        bi, ci = (t.repeat(1, 1, 2, 1)[:, :, :3] for t in (bi, ci))
    else:
        kw["initial_state"] = st0[:, :2]
    with pytest.raises(TypeError if bad == "dtype" else ValueError):
        ssd_scan(x, dt, a, bi, ci, **kw)


def test_cpu_tensors_never_build_or_count_k3(monkeypatch):
    def no_build(*_a, **_k):
        raise AssertionError("a CPU tensor reached the CUDA build")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "library", no_build)
    before = ssd_scan.launches
    ssd_scan(*_t(_ssd_inputs(7, 1, 64, 2, 16, 1, 8)), chunk=32)
    assert ssd_scan.launches == before


# --------------------------------------------------------------------------
# models/ssm.py against JAX
# --------------------------------------------------------------------------

def test_causal_conv():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 16, 40)).astype(np.float32)
    w = rng.standard_normal((4, 40)).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    out = ssm._causal_conv(*_t([x, w, b]))
    ref = jax_ssm._causal_conv(*map(jnp.asarray, (x, w, b)))
    assert out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), ref, **MODULE_TOL)


@pytest.mark.parametrize("init", [False, True])
def test_ssd_chunked(init):
    arrays = _ssd_inputs(9, 2, 128, 4, 32, 2, 16, init=init)
    st0 = arrays.pop() if init else None
    y, st = ssm.ssd_chunked(*_t(arrays), 32,
                            None if st0 is None else torch.from_numpy(st0))
    ry, rst = jax_ssm.ssd_chunked(*map(jnp.asarray, arrays), 32,
                                  None if st0 is None else jnp.asarray(st0))
    np.testing.assert_allclose(y.numpy(), ry, **CHUNK_TOL)
    np.testing.assert_allclose(st.numpy(), rst, **CHUNK_TOL)


def test_ssd_decode_step():
    x, dt, a, bi, ci, st0 = _ssd_inputs(10, 2, 1, 4, 16, 2, 8, init=True)
    y, st = ssm.ssd_decode_step(*_t([x, dt, a, bi, ci, st0]))
    ry, rst = jax_ssm.ssd_decode_step(*map(jnp.asarray,
                                           (x, dt, a, bi, ci, st0)))
    np.testing.assert_allclose(y.numpy(), ry, **MODULE_TOL)
    np.testing.assert_allclose(st.numpy(), rst, **MODULE_TOL)


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
def test_mamba2_forward_prefill(impl):
    jcfg, tcfg = _configs(impl)
    rng = np.random.default_rng(11)
    jp, tp = _both(_np_tree(jax_ssm.ssm_specs(jcfg), rng))
    x = rng.standard_normal((2, 64, jcfg.d_model)).astype(np.float32)
    out, st, conv = ssm.mamba2_forward(tcfg, tp, torch.from_numpy(x))
    rout, rst, rconv = jax_ssm.mamba2_forward(jcfg, jp, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), rout, **MODEL_TOL)
    np.testing.assert_allclose(st.numpy(), rst, **MODEL_TOL)
    np.testing.assert_allclose(conv.numpy(), rconv, **MODULE_TOL)


def test_mamba2_forward_decode():
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(12)
    jp, tp = _both(_np_tree(jax_ssm.ssm_specs(jcfg), rng))
    s = jcfg.ssm
    nh, di = s.n_heads(jcfg.d_model), s.d_inner(jcfg.d_model)
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    sst = rng.standard_normal((2, nh, s.head_dim, s.d_state)).astype(
        np.float32)
    cst = rng.standard_normal((2, s.d_conv - 1, di + 2 * s.d_state)).astype(
        np.float32)
    out, nst, ncst = ssm.mamba2_forward(tcfg, tp, *_t([x, sst, cst]),
                                        decode=True)
    rout, rst, rcst = jax_ssm.mamba2_forward(
        jcfg, jp, *map(jnp.asarray, (x, sst, cst)), decode=True)
    np.testing.assert_allclose(out.numpy(), rout, **MODEL_TOL)
    np.testing.assert_allclose(nst.numpy(), rst, **MODEL_TOL)
    np.testing.assert_allclose(ncst.numpy(), rcst, **MODULE_TOL)


# --------------------------------------------------------------------------
# the LM on mamba2-smoke
# --------------------------------------------------------------------------

def _batches(toks):
    targets = np.roll(toks, -1, axis=1)
    return ({"tokens": jnp.asarray(toks), "targets": jnp.asarray(targets)},
            {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(targets)})


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
def test_forward_loss_and_logits(impl):
    jcfg, tcfg = _configs(impl)
    jp, tp = _params(jcfg)
    jb, tb = _batches(_tokens(13, 2, 64, jcfg.vocab_size))
    loss, logits = transformer.forward(tcfg, tp, tb)
    rloss, rlogits = jax_tf.forward(jcfg, jp, jb)
    np.testing.assert_allclose(logits.numpy(), rlogits, **MODEL_TOL)
    np.testing.assert_allclose(float(loss), float(rloss), **MODEL_TOL)


@pytest.mark.parametrize("impl", ["kernel", "chunked", "dense"])
def test_prefill_logits(impl):
    jcfg, tcfg = _configs(impl)
    jp, tp = _params(jcfg, seed=1)
    jb, tb = _batches(_tokens(14, 2, 96, jcfg.vocab_size))
    out = transformer.prefill(tcfg, tp, tb)
    ref = jax_tf.prefill(jcfg, jp, jb)
    assert out.shape == (2, jcfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), ref, **MODEL_TOL)


def test_cache_specs_equal_jax():
    jcfg, tcfg = _configs()
    jspecs = jax_tf.init_cache_specs(jcfg, 3, 16)
    tspecs = transformer.init_cache_specs(tcfg, 3, 16)
    assert ({k: (s.shape, s.axes, s.dtype) for k, s in tspecs.items()}
            == {k: (s.shape, s.axes, s.dtype) for k, s in jspecs.items()})
    assert set(tspecs) == {"index", "ssm_state", "conv_state"}


def test_decode_step_logits_and_caches():
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, seed=2)
    b = 2
    jcache = jax_init_params(jax_tf.init_cache_specs(jcfg, b, 8),
                             jax.random.PRNGKey(0))
    tcache = params_from_jax(jax.tree.map(np.asarray, jcache), device="cpu")
    toks = _tokens(15, b, 4, jcfg.vocab_size)
    for i in range(toks.shape[1]):
        step = toks[:, i:i + 1]
        logits, tcache = transformer.decode_step(
            tcfg, tp, tcache, {"tokens": torch.from_numpy(step)})
        rlogits, jcache = jax_tf.decode_step(jcfg, jp, jcache,
                                             {"tokens": jnp.asarray(step)})
        np.testing.assert_allclose(logits.numpy(), rlogits, **MODEL_TOL)
    assert int(tcache["index"]) == int(jcache["index"]) == 4
    for name in ("ssm_state", "conv_state"):
        ref = np.asarray(jcache[name])
        np.testing.assert_allclose(tcache[name].numpy(), ref, rtol=1e-4,
                                   atol=STATE_REL * np.abs(ref).max())


def test_prefill_by_decode_matches_prefill():
    # the recurrent decode path and the chunked prefill path of the port
    # agree on the last token's logits
    jcfg, tcfg = _configs()
    _, tp = _params(jcfg, seed=3)
    toks = torch.from_numpy(_tokens(16, 2, 64, tcfg.vocab_size))
    cache = init_params(transformer.init_cache_specs(tcfg, 2, 64),
                        torch.Generator(), "cpu")
    for i in range(toks.shape[1]):
        logits, cache = transformer.decode_step(tcfg, tp, cache,
                                                {"tokens": toks[:, i:i + 1]})
    np.testing.assert_allclose(
        logits.numpy(),
        transformer.prefill(tcfg, tp, {"tokens": toks}).numpy(), **MODEL_TOL)


@pytest.mark.parametrize("full", [False, True],
                         ids=["smoke", "full_width_one_layer"])
def test_greedy_tokens_identical_to_jax(full):
    # serve/decode.py needs no SSM code: its cache comes from
    # init_cache_specs, which gives the SSM family its state caches
    kw = dict(num_layers=1, vocab_size=512) if full else {}
    jcfg, tcfg = _configs(full=full, **kw)
    jp, tp = _params(jcfg, seed=4)
    prompt = _tokens(17, 2, 5, jcfg.vocab_size)
    out = greedy_decode(tcfg, tp, torch.from_numpy(prompt),
                        max_new_tokens=6, max_len=16)
    ref = jax_greedy_decode(jcfg, jp, jnp.asarray(prompt), max_new_tokens=6,
                            max_len=16)
    assert out.steps == ref.steps == 6
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))


def test_full_width_one_layer_prefill():
    # mamba2-370m's widths (d_model 1024, 32 heads of 64, d_state 128,
    # chunk 256) with the depth and vocab cut to fit a CPU test; 512 tokens
    # give the scan two chunks.  The reference's fan-in of a stacked weight
    # is its layer count, so with one layer dt reaches ~30 and the chunk's
    # cumulative decays ~-1e5, where the two frameworks' f32 cumsums differ
    # by an ulp (~1e-2) and exp(dacs_i - dacs_j) carries it: held to the JAX
    # package's own SSD tolerance.  The kernel and chunked paths of the port
    # share their cumsum and agree to MODEL_TOL.
    outs = {}
    for impl in ("kernel", "chunked"):
        jcfg, tcfg = _configs(impl, full=True, num_layers=1, vocab_size=512)
        jp, tp = _params(jcfg, seed=5)
        jb, tb = _batches(_tokens(18, 1, 512, jcfg.vocab_size))
        outs[impl] = transformer.prefill(tcfg, tp, tb).numpy()
        ref = jax_tf.prefill(jcfg, jp, jb)
        np.testing.assert_allclose(outs[impl], ref, **SSD_TOL)
    np.testing.assert_allclose(outs["kernel"], outs["chunked"], **MODEL_TOL)


def test_transformer_lm_serves_mamba():
    jcfg, tcfg = _configs()
    _, tp = _params(jcfg, seed=6)
    model = transformer.TransformerLM(tcfg, tp)
    prompt = torch.from_numpy(_tokens(19, 2, 5, tcfg.vocab_size))
    np.testing.assert_array_equal(
        model.generate(prompt, 4, 16).tokens.numpy(),
        greedy_decode(tcfg, tp, prompt, 4, 16).tokens.numpy())
