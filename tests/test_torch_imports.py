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
print(len(names))
"""


def test_every_module_and_chip_smoke_import_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # configs (8), device, kernels (11), models (9), serve (2), train (6),
    # launch (2)
    assert int(proc.stdout.split()[-1]) >= 39


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny() -> ModelConfig:
    return get_smoke_config("llama3-1b").scaled(num_layers=1)


@pytest.mark.parametrize("entry", [
    "resolve_device", "init_params", "params_from_jax", "TransformerLM"])
def test_entry_points_need_a_card_unless_asked_for_cpu(no_cuda, entry):
    cfg = _tiny()
    specs = transformer.model_specs(cfg)
    calls = {
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
