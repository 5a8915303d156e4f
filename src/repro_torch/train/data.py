"""Synthetic-but-deterministic data pipeline.

The counterpart of the JAX package's ``train/data.py``: a host-side token
stream with a resumable cursor (checkpointable), drawn from numpy's
generator with the reference's seeding, so the batches equal the
reference's bit for bit.  ``__next__`` returns numpy arrays; the train loop
moves them to its device.  ``ShardedLoader``, which places batches on a
mesh, waits for the distribution slice (ROADMAP, Queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend: str = "none"
    d_model: int = 0


class SyntheticSource:
    """Deterministic LM batches from a counter-seeded RNG (resumable)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step

    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed * 1_000_003 + self.step)
        self.step += 1
        b, s = cfg.global_batch, cfg.seq_len
        if cfg.frontend == "stub":
            batch = {
                "embeds": rng.standard_normal(
                    (b, s, cfg.d_model), dtype=np.float32),
                "targets": rng.integers(0, cfg.vocab_size, (b, s),
                                        dtype=np.int32),
            }
        else:
            tokens = rng.integers(0, cfg.vocab_size, (b, s + 1),
                                  dtype=np.int32)
            batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
        return batch


class ShardedLoader:
    """Placement of host batches onto a mesh: not ported yet."""

    def __init__(self, source, mesh, rules=None):
        raise NotImplementedError(
            "ShardedLoader needs a device mesh, which waits for the "
            "distribution slice (ROADMAP, Queue 1)")
