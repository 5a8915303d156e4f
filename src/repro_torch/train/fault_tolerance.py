"""Fault tolerance & elasticity for 1000+-node operation.

Three mechanisms, all exercised by tests and the train loop:

1. **Checkpoint/restart** — CheckpointManager's commit protocol + the train
   loop's `--resume` path.  MTBF-driven save cadence: given per-node MTBF
   and node count, `recommended_interval` balances lost-work vs save cost
   (Young/Daly first-order optimum: sqrt(2 · δ · MTBF_cluster)).

2. **Straggler mitigation** — per-step wall-time EWMA + spike detector.  On
   a real pod the runner reacts by (a) excluding the slow host from the
   next re-mesh, or (b) enabling gradient compression to shrink the
   collective the straggler gates.  The HeSPaS network model quantifies the
   benefit ahead of time (`straggler_factor` in the scheduler).

3. **Elastic re-meshing** — shrink/grow the data axis when nodes fail or
   return.  Because parameters are FSDP-sharded over "data", re-meshing is
   a checkpoint-restore onto a new mesh with different shardings — the
   layout-independent checkpoint format makes this a pure restart path.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field


def recommended_interval(save_cost_s: float, node_mtbf_hours: float,
                         num_nodes: int) -> float:
    """Young/Daly optimal checkpoint interval (seconds)."""
    cluster_mtbf_s = node_mtbf_hours * 3600.0 / max(num_nodes, 1)
    return math.sqrt(2.0 * save_cost_s * cluster_mtbf_s)


@dataclass
class StragglerDetector:
    """EWMA step-time tracker; flags steps slower than ``threshold``×mean."""
    alpha: float = 0.1
    threshold: float = 2.0
    ewma: float = 0.0
    count: int = 0
    flagged: list = field(default_factory=list)

    def observe(self, step: int, wall_s: float) -> bool:
        if self.count == 0:
            self.ewma = wall_s
        is_straggler = (self.count >= 5
                        and wall_s > self.threshold * self.ewma)
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * wall_s
        self.count += 1
        if is_straggler:
            self.flagged.append((step, wall_s, self.ewma))
        return is_straggler


@dataclass
class ElasticPlan:
    """Re-mesh decision when the healthy-device count changes."""
    mesh_shape: tuple[int, ...]
    mesh_axes: tuple[str, ...]
    global_batch: int
    note: str = ""


def plan_remesh(healthy_devices: int, model_parallel: int,
                global_batch: int, axes=("data", "model")) -> ElasticPlan:
    """Keep the model axis intact (TP must match the weight partitioning);
    shrink the data axis to the largest multiple that fits; rescale the
    batch so per-device load is constant."""
    if healthy_devices < model_parallel:
        raise RuntimeError(
            f"cannot keep model_parallel={model_parallel} with only "
            f"{healthy_devices} devices")
    data = healthy_devices // model_parallel
    # largest power of two <= data keeps collectives ring-friendly
    data = 1 << (data.bit_length() - 1)
    new_batch = max(1, global_batch * data * model_parallel
                    // (healthy_devices))
    # round batch to a multiple of the data axis
    new_batch = max(data, (new_batch // data) * data)
    return ElasticPlan(
        mesh_shape=(data, model_parallel), mesh_axes=tuple(axes),
        global_batch=new_batch,
        note=f"re-meshed to {data}x{model_parallel} "
             f"({healthy_devices} healthy devices)")


@dataclass
class HeartbeatMonitor:
    """Tracks liveness of simulated hosts; drives elastic re-meshing."""
    timeout_s: float = 60.0
    last_seen: dict = field(default_factory=dict)

    def beat(self, host: int, now: float | None = None) -> None:
        self.last_seen[host] = now if now is not None else time.time()

    def dead_hosts(self, now: float | None = None) -> list[int]:
        t = now if now is not None else time.time()
        return [h for h, seen in self.last_seen.items()
                if t - seen > self.timeout_s]
