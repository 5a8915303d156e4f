"""One rank of a gloo world for ``tests/test_torch_distributed.py``.

Imported by the spawned rank processes (not a test module): it imports
torch and ``repro_torch`` only.  Each rank joins a gloo world through a
``FileStore``, builds a mesh (``[world, 1]`` unless given a shape: ``[data,
model]`` or ``[pod, data, model]``) and runs one job:

* ``"step"``: the per-rank ``make_train_step`` for two steps from the whole
  parameters and batches in ``inputs.pt``; it saves its shards and rows
  before the first step and every step's flattened outputs;
* ``"train"``: ``train(run, mesh=...)`` for two steps; it saves the losses;
* ``"resnet"``: one ResNet rank step (``tests/test_torch_resnet.py``) from
  the whole parameters and images in ``inputs.pt``, on the rank's rows; it
  saves the loss, the gradient norm (the step's clip takes it the same way),
  the loss with batch-norm statistics over the rank's rows only, its new
  shards and moments, and each leaf's sharded dim;
* ``"tp"`` (``tests/test_torch_tensor_parallel.py``): for each case in
  ``inputs.pt`` (a config, an optimizer config, the whole parameters and
  batches) the per-rank ``make_train_step`` for every batch and the
  per-rank forward on the first; it saves the rank's coordinates, its
  shards and rows before the first step, each step's new shards, moments
  and metrics, and the forward's loss and logits, as trees;
* ``"ep"`` (``tests/test_torch_expert_parallel.py``): ``"tp"``'s cases,
  then each MoE case in ``modules.pt`` (a config, the whole MoE weights
  and tokens x [B, S, d]): the rank's MoE (``models/mlp.py::moe_forward``
  under the mesh's model axis) on its rows of x, from its shards gathered
  along ``data``; it saves the coordinates and the output.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

# a collective that waits longer than this fails the rank
COLLECTIVE_TIMEOUT_S = 60


def run(rank: int, world: int, store: str, work: str, job: str,
        shape: tuple[int, ...] | None = None) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        from repro_torch.launch.mesh import make_mesh, mesh_axes

        shape = tuple(shape or (world, 1))
        mesh = make_mesh(shape, mesh_axes(shape), "cpu")
        out = {"step": _step, "train": _train, "resnet": _resnet,
               "tp": _tp, "ep": _ep}[job](mesh, work)
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _step(mesh, work: str) -> dict:
    from repro_torch.models.params import shard_params
    from repro_torch.models.transformer import model_specs
    from repro_torch.train.data import ShardedLoader
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import adamw_init

    inputs = torch.load(os.path.join(work, "inputs.pt"),
                        weights_only=False)
    cfg, opt_cfg = inputs["cfg"], inputs["opt_cfg"]
    specs = model_specs(cfg)
    params = shard_params(specs, inputs["params"], mesh)
    opt = adamw_init(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg, mesh=mesh)
    loader = ShardedLoader(iter(inputs["batches"]), mesh)
    first = next(loader)
    out = {"inputs": pytree.tree_leaves((params, opt, first)), "steps": []}
    batch = first
    for i in range(len(inputs["batches"])):
        if i:
            batch = next(loader)
        params, opt, metrics = step(params, opt, batch)
        out["steps"].append(pytree.tree_leaves((params, opt, metrics)))
    return out


def _tp(mesh, work: str) -> list:
    from repro_torch.models.params import shard_params
    from repro_torch.models.transformer import model_specs
    from repro_torch.train.data import ShardedLoader
    from repro_torch.train.loop import make_forward, make_train_step
    from repro_torch.train.optimizer import adamw_init

    inputs = torch.load(os.path.join(work, "inputs.pt"),
                        weights_only=False)
    outs = []
    for case in inputs:
        cfg, opt_cfg = case["cfg"], case["opt_cfg"]
        params = shard_params(model_specs(cfg), case["params"], mesh)
        opt = adamw_init(params, opt_cfg)
        step = make_train_step(cfg, opt_cfg, mesh=mesh)
        rows = list(ShardedLoader(iter(case["batches"]), mesh))
        out = {"coordinate": mesh.get_coordinate(),
               "inputs": (params, opt, rows[0]), "steps": []}
        for batch in rows:
            params, opt, metrics = step(params, opt, batch)
            out["steps"].append((params, opt, metrics))
        first = shard_params(model_specs(cfg), case["params"], mesh)
        out["forward"] = make_forward(cfg, mesh)(first, rows[0])
        outs.append(out)
    return outs


def _ep(mesh, work: str) -> dict:
    from repro_torch.distributed import tensor_parallel
    from repro_torch.distributed.data_parallel import DataParallel
    from repro_torch.models import mlp
    from repro_torch.models.params import shard_params

    out = {"cases": _tp(mesh, work), "modules": []}
    path = os.path.join(work, "modules.pt")
    cases = torch.load(path, weights_only=False) if os.path.exists(path) \
        else []
    at = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    for case in cases:
        cfg, x = case["cfg"], case["x"]
        specs = mlp.moe_specs(cfg)
        dp = DataParallel(specs, mesh)
        block = at.get("pod", 0) * dp.size + at["data"]
        rows = x.shape[0] // dp.ranks
        with tensor_parallel.active(tensor_parallel.for_mesh(cfg, mesh)):
            y = mlp.moe_forward(cfg, dp.gather(shard_params(
                specs, case["params"], mesh)), x[block * rows:
                                                 (block + 1) * rows])
        out["modules"].append({"coordinate": mesh.get_coordinate(),
                               "y": y})
    return out


def _train(mesh, work: str) -> dict:
    from repro_torch.train.loop import train

    run_cfg = torch.load(os.path.join(work, "run.pt"), weights_only=False)
    res = train(run_cfg, mesh=mesh, num_steps=2, log_every=0)
    return {"losses": res.losses}


def _resnet(mesh, work: str) -> dict:
    from repro_torch.distributed.data_parallel import DataParallel
    from repro_torch.models import resnet
    from repro_torch.models.params import shard_params
    from repro_torch.train.optimizer import adamw_init

    inputs = torch.load(os.path.join(work, "inputs.pt"),
                        weights_only=False)
    cfg, opt_cfg = inputs["cfg"], inputs["opt_cfg"]
    specs = resnet.resnet_specs(cfg)
    params = shard_params(specs, inputs["params"], mesh)
    dp = DataParallel(specs, mesh)
    rows = inputs["images"].shape[0] // dp.size
    r = mesh.get_local_rank("data")
    images = inputs["images"][r * rows:(r + 1) * rows]
    labels = inputs["labels"][r * rows:(r + 1) * rows]
    _, grads = resnet._value_and_grad(cfg, params, images, labels, dp.group,
                                      dp.gather)
    norm = dp.global_norm(dp.reduce_grads(grads))
    local_loss, _ = resnet.resnet_forward(cfg, dp.gather(params), images,
                                          labels)
    step = resnet.make_resnet_train_step(cfg, opt_cfg, mesh=mesh)
    new, opt, loss = step(params, adamw_init(params, opt_cfg), images,
                          labels)

    def dims(t):
        if isinstance(t, dict):
            return {k: dims(v) for k, v in t.items()}
        return t[0]
    return {"loss": loss, "grad_norm": norm, "local_loss": local_loss,
            "params": new, "m": opt["m"], "v": opt["v"],
            "dims": dims(dp.dims)}
