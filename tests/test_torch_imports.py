"""The port imports nothing of JAX or of the JAX package, and its entry
points refuse to run without a card unless the caller asks for the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import params, transformer
from repro_torch.models.registry import get_smoke_config

ROOT = Path(__file__).resolve().parents[1]

_BLOCKED_IMPORT = r"""
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None      # any "import jax" now raises ImportError
sys.modules["repro"] = None    # and so does any import of the JAX package
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro")
                and sys.modules[m] is not None)
assert not leaked, leaked
print(" ".join(names))
"""


def test_every_module_and_chip_smoke_import_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # configs (15: with deepseek-67b, qwen2.5-32b, gemma2-27b,
    # mixtral-8x22b, stablelm-12b, zamba2-2.7b and deepseek-v3-671b),
    # device, library, api, kernels (11), models (10: with resnet), serve
    # (3: the package, decode, faults), train (6), launch
    # (3: the package, train, mesh), distributed (3: the package,
    # sharding, data_parallel), campaign (8: the package, spec, builders,
    # plans, summary, report, runner, __main__), core (8: the package,
    # export, stablehlo, executor, pipeline, registry, systems, catalog)
    # with its ir (10), slicing (5: with emit), estimators (8: with
    # profiling and learned), network (4) and trace (2) subpackages,
    # search (6: the package, pareto, spec, engine, report, __main__) and
    # tools (2: the package, fit_learned_model)
    names = proc.stdout.split()
    assert len(names) >= 106
    assert {"repro_torch.core.executor", "repro_torch.core.slicing.emit",
            "repro_torch.core.estimators.profiling",
            "repro_torch.core.estimators.learned",
            "repro_torch.search", "repro_torch.search.pareto",
            "repro_torch.search.spec", "repro_torch.search.engine",
            "repro_torch.search.report", "repro_torch.search.__main__",
            "repro_torch.tools.fit_learned_model",
            "repro_torch.configs.deepseek_67b",
            "repro_torch.configs.qwen2_5_32b",
            "repro_torch.configs.gemma2_27b",
            "repro_torch.configs.mixtral_8x22b",
            "repro_torch.configs.stablelm_12b",
            "repro_torch.configs.zamba2_2_7b",
            "repro_torch.configs.deepseek_v3_671b"} <= set(names)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny() -> ModelConfig:
    return get_smoke_config("llama3-1b").scaled(num_layers=1)


@pytest.mark.parametrize("entry", [
    "resolve_device", "init_params", "params_from_jax", "TransformerLM",
    "Executor", "ProfilingEstimator", "host_system"])
def test_entry_points_need_a_card_unless_asked_for_cpu(no_cuda, entry):
    from repro_torch.core.estimators.profiling import ProfilingEstimator
    from repro_torch.core.executor import Executor
    from repro_torch.core.systems import host_system
    cfg = _tiny()
    specs = transformer.model_specs(cfg)
    module = ("module @m {\n  func.func public @main(%arg0: tensor<2xf32>) "
              "-> tensor<2xf32> {\n    return %arg0 : tensor<2xf32>\n  }\n"
              "}\n")
    calls = {
        "Executor": lambda **kw: Executor(module, **kw),
        "ProfilingEstimator": lambda **kw: ProfilingEstimator(**kw),
        "host_system": lambda **kw: host_system(**kw),
        "resolve_device": lambda **kw: resolve_device(**kw),
        "init_params": lambda **kw: params.init_params(
            specs, torch.Generator(), **kw),
        "params_from_jax": lambda **kw: params.params_from_jax(
            {"w": [[1.0, 2.0]]}, **kw),
        "TransformerLM": lambda **kw: transformer.TransformerLM(
            cfg, generator=torch.Generator(), **kw),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    calls[entry](device="cpu")   # the CPU only when asked for
