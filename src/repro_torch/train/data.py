"""Synthetic-but-deterministic data pipeline.

The counterpart of the JAX package's ``train/data.py``: a host-side token
stream with a resumable cursor (checkpointable), drawn from numpy's
generator with the reference's seeding, so the batches equal the
reference's bit for bit.  ``__next__`` returns numpy arrays; the train loop
moves them to its device; :class:`ShardedLoader` gives a rank of a mesh
its rows of each batch.
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
    """This rank's rows of each host batch, on the mesh's device: the
    counterpart of the reference's placement of each batch onto the mesh
    with the activation sharding (``batch`` over ``(pod, data)``, pod
    major: every model rank of the same pod and data coordinates takes the
    same rows).  It keeps one batch of prefetch, as the
    reference does."""

    _AXES = {
        "tokens": ("batch", "seq"),
        "targets": ("batch", "seq"),
        "embeds": ("batch", "seq", "embed"),
        "mrope_positions": ("norm", "batch", "seq"),
    }

    def __init__(self, source, mesh, rules=None):
        self.source = source
        self.mesh = mesh
        self.rules = rules
        self._pending = None

    def _place(self, batch: dict) -> dict:
        import torch

        from ..distributed.sharding import act_sharding, shard_range
        out = {}
        for k, v in batch.items():
            layout = act_sharding(self._AXES[k], self.mesh, self.rules,
                                  v.shape)
            for dim in range(v.ndim):
                start, stop = shard_range(v.shape, layout, dim, self.mesh)
                v = v[(slice(None),) * dim + (slice(start, stop),)]
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(
                self.mesh.device_type)
        return out

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._pending is None:
            self._pending = self._place(next(self.source))
        out = self._pending
        try:
            self._pending = self._place(next(self.source))
        except StopIteration:
            self._pending = None
        return out
