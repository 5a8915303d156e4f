"""The port's serving loop and parameter plumbing against the JAX package on
the CPU: greedy tokens identical in f32, the KV-cache boundary, bf16
parameters carried across bit for bit, and parameter counts from specs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import params as jax_params
from repro.models import transformer as jax_tf
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import get_smoke_config as jax_get_smoke_config
from repro.serve.decode import greedy_decode as jax_greedy_decode
from repro_torch.models import params, transformer
from repro_torch.models.registry import get_config, get_smoke_config
from repro_torch.serve.decode import greedy_decode

LLAMAS = ["llama3-100m", "llama3-500m", "llama3-1b", "llama3-3b", "llama2-7b"]


def _f32_pair(full: bool, **kw):
    jget, tget = ((jax_get_config, get_config) if full
                  else (jax_get_smoke_config, get_smoke_config))
    jcfg = jget("llama3-1b").scaled(dtype="float32", **kw)
    tcfg = tget("llama3-1b").scaled(dtype="float32", **kw)
    jp = jax_params.init_params(jax_tf.model_specs(jcfg),
                                jax.random.PRNGKey(0))
    tp = params.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _prompt(b, s, vocab):
    return np.random.default_rng(0).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("full", [False, True],
                         ids=["smoke", "full_width_one_layer"])
def test_greedy_tokens_identical_to_jax(full):
    kw = dict(num_layers=1, vocab_size=512) if full else {}
    jcfg, tcfg, jp, tp = _f32_pair(full, **kw)
    prompt = _prompt(2, 5, jcfg.vocab_size)
    out = greedy_decode(tcfg, tp, torch.from_numpy(prompt),
                        max_new_tokens=6, max_len=16)
    ref = jax_greedy_decode(jcfg, jp, jnp.asarray(prompt), max_new_tokens=6,
                            max_len=16)
    assert out.steps == ref.steps == 6
    assert out.tokens.dtype == torch.int32
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))


@pytest.mark.parametrize("max_new_tokens,raises", [(12, False), (13, True)],
                         ids=["exactly_full", "one_past"])
def test_greedy_decode_cache_boundary(max_new_tokens, raises):
    cfg = get_smoke_config("llama3-1b").scaled(dtype="float32")
    gen = torch.Generator().manual_seed(0)
    tp = params.init_params(transformer.model_specs(cfg), gen, device="cpu")
    prompt = torch.from_numpy(_prompt(1, 4, cfg.vocab_size))
    if raises:
        with pytest.raises(ValueError, match="exceeds the KV cache"):
            greedy_decode(cfg, tp, prompt, max_new_tokens, max_len=16)
    else:
        out = greedy_decode(cfg, tp, prompt, max_new_tokens, max_len=16)
        assert out.tokens.shape == (1, max_new_tokens)


def test_bf16_params_from_jax_bit_exact():
    # a llama tree (bf16 only) and a mamba2 tree (bf16, and a_log in f32)
    for arch in ("llama3-1b", "mamba2-370m"):
        cfg = jax_get_smoke_config(arch)
        assert cfg.dtype == "bfloat16"
        jp = jax_params.init_params(jax_tf.model_specs(cfg),
                                    jax.random.PRNGKey(1))
        tp = params.params_from_jax(jax.tree.map(np.asarray, jp),
                                    device="cpu")
        jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
        assert len(jflat) == len(jax.tree_util.tree_leaves(tp))
        for path, leaf in jflat:
            t = tp
            for key in path:
                t = t[key.key]
            leaf = np.asarray(leaf)
            if path[-1].key == "a_log":
                assert t.dtype == torch.float32
                np.testing.assert_array_equal(t.view(torch.int32).numpy(),
                                              leaf.view(np.int32))
                continue
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          leaf.view(np.int16))


@pytest.mark.parametrize("arch", LLAMAS + ["mamba2-370m"])
def test_param_count_and_tree_equal_jax(arch):
    jspecs = jax_tf.model_specs(jax_get_config(arch))
    tspecs = transformer.model_specs(get_config(arch))
    assert params.param_count(tspecs) == jax_params.param_count(jspecs)
    assert params.param_bytes(tspecs) == jax_params.param_bytes(jspecs)
    jpaths = {k: (s.shape, s.axes, s.init, s.dtype)
              for k, s in jax_params.tree_paths(jspecs).items()}
    tpaths = {k: (s.shape, s.axes, s.init, s.dtype)
              for k, s in params.tree_paths(tspecs).items()}
    assert tpaths == jpaths


def test_transformer_lm_module_serves_like_the_functions():
    cfg, tcfg, jp, tp = _f32_pair(False)
    model = transformer.TransformerLM(tcfg, tp)
    assert (sum(p.numel() for p in model.parameters())
            == params.param_count(transformer.model_specs(tcfg)))
    assert not any(p.requires_grad for p in model.parameters())
    prompt = torch.from_numpy(_prompt(2, 5, tcfg.vocab_size))
    np.testing.assert_array_equal(
        model.generate(prompt, 4, 16).tokens.numpy(),
        greedy_decode(tcfg, tp, prompt, 4, 16).tokens.numpy())
    torch.testing.assert_close(model.prefill({"tokens": prompt}),
                               transformer.prefill(tcfg, tp,
                                                   {"tokens": prompt}))


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "zamba2-2.7b",
                                  "deepseek-v3-671b"])
def test_unported_families_raise(arch):
    from repro_torch.models.registry import get_config as tget
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tget(arch)
