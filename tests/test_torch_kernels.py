"""The port's kernels K1 (flash attention) and K2 (RMSNorm) against the JAX
package: their plain versions against the Pallas kernels (interpret mode, as
tests/test_kernels.py runs them) and the JAX oracles on the CPU.  The CUDA
kernels are held against their plain versions on the card in
tests/test_torch_cuda.py.  Inputs come from numpy's seeded generator and go to both
frameworks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro.models.attention import AttnArgs as JaxAttnArgs
from repro.models.attention import _chunked_attention as jax_chunked
from repro.models.attention import _dense_attention as jax_dense
from repro.models.common import rms_norm as jax_rms_norm
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                      kernel_error)
from repro_torch.kernels.rmsnorm.ops import rmsnorm

F32_ATOL = 2e-5     # tests/test_kernels.py's f32 tolerance for K1
BF16_ATOL = 3e-2    # ... and its bf16 tolerance (one bf16 ulp near 4)
RMS_ATOL = {np.float32: 1e-5, "bfloat16": 5e-2}   # K2, as for the Pallas kernel


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _qkv(seed, b, hq, hkv, sq, skv, d):
    return _normal(seed, (b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# --------------------------------------------------------------------------
# K1: flash attention, plain version vs JAX
# --------------------------------------------------------------------------

class TestFlashAttentionPlain:
    @pytest.mark.parametrize("b,hq,hkv,sq,skv,d", [
        (2, 4, 2, 256, 256, 64),
        (1, 4, 4, 128, 256, 64),
        (2, 2, 2, 256, 256, 32),
        (1, 8, 2, 128, 128, 128),
    ])
    def test_matches_pallas_and_ref_causal(self, b, hq, hkv, sq, skv, d):
        q, k, v = _qkv(0, b, hq, hkv, sq, skv, d)
        out = flash_attention(*_torch([q, k, v]), causal=True)
        pallas = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True)
        g = hq // hkv
        ref = attention_ref(jnp.asarray(q), jnp.repeat(k, g, axis=1),
                            jnp.repeat(v, g, axis=1), causal=True)
        np.testing.assert_allclose(_np(out), pallas, atol=F32_ATOL,
                                   rtol=F32_ATOL)
        np.testing.assert_allclose(_np(out), ref, atol=F32_ATOL, rtol=F32_ATOL)

    @pytest.mark.parametrize("window,cap,causal", [
        (128, 0.0, True), (0, 50.0, True), (64, 30.0, True), (0, 0.0, False),
    ])
    def test_masking_variants(self, window, cap, causal):
        q, k, v = _qkv(1, 1, 2, 2, 256, 256, 64)
        kw = dict(causal=causal, window=window, logit_cap=cap)
        out = flash_attention(*_torch([q, k, v]), **kw)
        pallas = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           **kw)
        ref = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            **kw)
        np.testing.assert_allclose(_np(out), pallas, atol=F32_ATOL,
                                   rtol=F32_ATOL)
        np.testing.assert_allclose(_np(out), ref, atol=F32_ATOL, rtol=F32_ATOL)

    def test_bf16(self):
        q, k, v = _qkv(2, 1, 2, 2, 128, 128, 64)
        out = flash_attention(*_torch([q, k, v], torch.bfloat16))
        jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
        pallas = jax_flash(jq, jk, jv)
        ref = attention_ref(jq, jk, jv)
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(out), np.asarray(pallas, np.float32),
                                   atol=BF16_ATOL)
        np.testing.assert_allclose(_np(out), np.asarray(ref, np.float32),
                                   atol=BF16_ATOL)

    @pytest.mark.parametrize("q_offset,window,cap", [
        (128, 0, 0.0), (128, 96, 0.0), (256, 0, 20.0)])
    def test_gqa_with_q_offset(self, q_offset, window, cap):
        # a query block that continues a longer key sequence (chunked
        # prefill): Sq=128 queries at positions q_offset.. over Skv keys
        q, k, v = _qkv(3, 2, 8, 2, 128, 128 + q_offset, 64)
        kw = dict(causal=True, window=window, logit_cap=cap,
                  q_offset=q_offset)
        out = flash_attention(*_torch([q, k, v]), **kw)
        pallas = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           **kw)
        np.testing.assert_allclose(_np(out), pallas, atol=F32_ATOL,
                                   rtol=F32_ATOL)

    @pytest.mark.parametrize("causal,window,cap", [
        (True, 0, 0.0), (True, 48, 0.0), (False, 0, 30.0)])
    def test_ragged_seq_against_chunked_and_dense(self, causal, window, cap):
        # Sq = Skv = 200: the Pallas kernel asserts Sq % block_q == 0 here,
        # so the reference is the JAX chunked and dense paths
        q, k, v = _qkv(4, 2, 4, 2, 200, 200, 64)
        out = _np(flash_attention(*_torch([q, k, v]), causal=causal,
                                  window=window, logit_cap=cap))
        args = JaxAttnArgs(causal=causal, window=window, logit_cap=cap)
        jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
        np.testing.assert_allclose(out, jax_chunked(jq, jk, jv, args, 64),
                                   atol=F32_ATOL, rtol=F32_ATOL)
        np.testing.assert_allclose(out, jax_dense(jq, jk, jv, args),
                                   atol=F32_ATOL, rtol=F32_ATOL)


# --------------------------------------------------------------------------
# K2: RMSNorm, plain version vs JAX
# --------------------------------------------------------------------------

class TestRMSNormPlain:
    @pytest.mark.parametrize("shape", [(4, 128, 512), (2, 64, 1024),
                                       (128, 768), (1, 1, 256)])
    @pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
    def test_matches_pallas_and_ref(self, shape, dtype):
        x, w = _normal(5, shape, shape[-1:])
        tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
        jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
        out = _np(rmsnorm(*_torch([x, w], tdt)))
        jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
        for ref in (jax_rmsnorm(jx, jw), jax_rmsnorm_ref(jx, jw)):
            np.testing.assert_allclose(out, np.asarray(ref, np.float32),
                                       atol=RMS_ATOL[dtype])

    @pytest.mark.parametrize("offset", [0.0, 1.0])
    @pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
    def test_offset_matches_common_rms_norm(self, offset, dtype):
        x, w = _normal(6, (3, 17, 256), (256,))
        w = 0.1 * w   # gemma-style weights stored as offsets from 1
        tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
        jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
        out = _np(rmsnorm(*_torch([x, w], tdt), eps=1e-6, offset=offset))
        ref = jax_rms_norm(jnp.asarray(x, jdt), jnp.asarray(w, jdt), 1e-6,
                           offset)
        np.testing.assert_allclose(out, np.asarray(ref, np.float32),
                                   atol=RMS_ATOL[dtype])


def test_cpu_tensors_never_launch_or_build(monkeypatch):
    def no_build(*_a, **_k):
        raise AssertionError("a CPU tensor reached the CUDA build")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "library", no_build)
    before = (flash_attention.launches, rmsnorm.launches)
    q, k, v = _torch(_qkv(7, 1, 2, 1, 16, 16, 32))
    flash_attention(q, k, v)
    rmsnorm(q, torch.ones(32))
    assert (flash_attention.launches, rmsnorm.launches) == before


def test_rmsnorm_refuses_a_weight_of_another_dtype():
    x = torch.ones(4, 32, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="w is torch.float32"):
        rmsnorm(x, torch.ones(32))


def test_kernel_error_flags_a_dropped_kv_tile():
    # the tolerance K1 is held to on the card, checked here on the CPU: the
    # plain version rounded to bf16 passes, and the same with the first
    # 64-key tile left out for the queries from 128 on fails
    q, k, v = _torch(_qkv(10, 1, 4, 2, 256, 256, 64), torch.bfloat16)
    good = flash_attention_ref(q, k, v)
    assert max(kernel_error(good, q, k, v)[1:]) <= 1.0
    bad = good.clone()
    bad[:, :, 128:] = flash_attention_ref(q[:, :, 128:], k[:, :, 64:],
                                          v[:, :, 64:], q_offset=64)
    _, elem, row = kernel_error(bad, q, k, v)
    assert elem > 1.0 and row > 1.0, (elem, row)
