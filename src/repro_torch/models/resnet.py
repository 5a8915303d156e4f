"""ResNet v1.5 (18/34/50/101/152/200): the paper's Fig 7 workload family
(data-parallel ResNet training on 4 cards), the port's counterpart of the
JAX package's ``models/resnet.py``.

The parameter tree, its leaf shapes (convolution weights HWIO), axes and
initializers are the reference's, so parameters carry across with
:func:`repro_torch.models.params.params_from_jax`.  Images are NHWC
``[B, H, W, 3]``, as in the reference; inside, the activations are NCHW
views (channels-last in memory), the layout ``F.conv2d`` takes.

The convolutions are ``F.conv2d`` (cuDNN on the card): the reference
computes them outside any Pallas kernel.  Its ``"SAME"`` padding is
asymmetric at stride 2 (the odd pixel at the high end: ``(2, 3)`` for the
7x7 stem, ``(0, 1)`` for a 3x3 convolution and for the max pool), which
``F.conv2d``'s padding cannot say, so such a window is padded explicitly and
then convolved (or pooled) unpadded.

Batch norm uses the batch's statistics (training mode), in f32 over
``(N, H, W)``, with the population variance; running averages are not
tracked.  On a data mesh (:func:`resnet_train_exports` with a mesh) the
statistics are summed over the data group, forward and backward
(synchronised batch norm): the reference's sharded ``jit`` takes its mean
over the whole batch, so a rank that normalised over its own images would
compute another function.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..distributed.data_parallel import DataParallel, all_reduce
from ..distributed.sharding import act_sharding, axis_sizes, shard_shape
from ..train.optimizer import (OptimizerConfig, make_optimizer,
                               opt_state_abstract, tree_leaves, tree_map)
from .common import barrier
from .params import DTYPES, ParamSpec, abstract_params, trainable

_STAGES = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
    200: ("bottleneck", (3, 24, 36, 3)),
}


@dataclass(frozen=True)
class ResNetConfig:
    depth: int = 50
    num_classes: int = 1000
    width: int = 64
    dtype: str = "float16"       # paper Table III: FP16
    block_barriers: bool = False  # optimization_barrier between blocks

    @property
    def block(self) -> str:
        return _STAGES[self.depth][0]

    @property
    def stage_sizes(self) -> tuple[int, ...]:
        return _STAGES[self.depth][1]


def _conv_spec(k, cin, cout, dt):
    return ParamSpec((k, k, cin, cout), ("conv", "conv", "embed", "mlp"),
                     init="scaled", dtype=dt)


def _bn_specs(c, dt):
    return {"scale": ParamSpec((c,), ("norm",), init="ones", dtype=dt),
            "bias": ParamSpec((c,), ("norm",), init="zeros", dtype=dt)}


def resnet_specs(cfg: ResNetConfig) -> dict:
    dt = cfg.dtype
    specs: dict = {"stem": {"conv": _conv_spec(7, 3, cfg.width, dt),
                            "bn": _bn_specs(cfg.width, dt)}}
    cin = cfg.width
    expansion = 4 if cfg.block == "bottleneck" else 1
    for si, n_blocks in enumerate(cfg.stage_sizes):
        cmid = cfg.width * (2 ** si)
        cout = cmid * expansion
        stage: dict = {}
        for bi in range(n_blocks):
            blk: dict = {}
            if cfg.block == "bottleneck":
                blk["conv1"] = _conv_spec(1, cin, cmid, dt)
                blk["bn1"] = _bn_specs(cmid, dt)
                blk["conv2"] = _conv_spec(3, cmid, cmid, dt)
                blk["bn2"] = _bn_specs(cmid, dt)
                blk["conv3"] = _conv_spec(1, cmid, cout, dt)
                blk["bn3"] = _bn_specs(cout, dt)
            else:
                blk["conv1"] = _conv_spec(3, cin, cmid, dt)
                blk["bn1"] = _bn_specs(cmid, dt)
                blk["conv2"] = _conv_spec(3, cmid, cout, dt)
                blk["bn2"] = _bn_specs(cout, dt)
            if cin != cout or bi == 0:
                blk["proj"] = _conv_spec(1, cin, cout, dt)
                blk["proj_bn"] = _bn_specs(cout, dt)
            stage[f"block{bi}"] = blk
            cin = cout
        specs[f"stage{si}"] = stage
    specs["head"] = ParamSpec((cin, cfg.num_classes), ("embed", "vocab"),
                              init="scaled", dtype=dt)
    return specs


def resnet_arch_config(arch: str) -> ResNetConfig:
    """``"resnet50"`` -> :class:`ResNetConfig` (campaign ``arch`` ids)."""
    if not arch.startswith("resnet"):
        raise ValueError(f"not a resnet arch id: {arch!r}")
    suffix = arch[len("resnet"):]
    if not suffix.isdigit() or int(suffix) not in _STAGES:
        raise ValueError(
            f"unknown resnet depth in {arch!r}; have {sorted(_STAGES)}")
    return ResNetConfig(depth=int(suffix))


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of a window ``k`` at ``stride`` over ``n``
    pixels: ``ceil(n / stride)`` outputs, the odd pixel of padding at the
    high end."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _window_pads(x: torch.Tensor, k: int, stride: int):
    """The (low, high) pads of H and W; ``None`` when each is symmetric."""
    ph = same_pads(x.shape[2], k, stride)
    pw = same_pads(x.shape[3], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return None, (ph[0], pw[0])
    return (*pw, *ph), (0, 0)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x: NCHW, w: HWIO; ``"SAME"`` padding, output in ``x.dtype``."""
    pad, padding = _window_pads(x, w.shape[0], stride)
    if pad is not None:
        x = F.pad(x, pad)
    return F.conv2d(x, w.to(x.dtype).permute(3, 2, 0, 1), stride=stride,
                    padding=padding)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3 max pool at stride 2 with ``"SAME"`` padding of -inf."""
    pad, padding = _window_pads(x, 3, 2)
    if pad is not None:
        x = F.pad(x, pad, value=float("-inf"))
    return F.max_pool2d(x, 3, 2, padding=padding)


class _SumOverRanks(torch.autograd.Function):
    """The sum of a tensor over a process group's ranks, whose cotangent is
    summed over the ranks too: every rank's loss depends on every rank's
    part of the sum, as in synchronised batch norm."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def _channel_sum(x: torch.Tensor, group) -> torch.Tensor:
    s = x.sum(dim=(0, 2, 3), keepdim=True)
    return s if group is None else _SumOverRanks.apply(s, group)


def _bn(x: torch.Tensor, p: dict, group=None, eps: float = 1e-5):
    """Batch norm over (N, H, W) of NCHW ``x``: the mean and the population
    variance in f32, summed over ``group``'s ranks when given; scale and
    bias in f32, then back to ``x.dtype``."""
    xf = x.to(torch.float32)
    count = x.shape[0] * x.shape[2] * x.shape[3]
    if group is not None:
        count *= group.size()
    mean = _channel_sum(xf, group) / count
    d = xf - mean
    var = _channel_sum(d * d, group) / count
    y = d * torch.rsqrt(var + eps)
    c = (1, -1, 1, 1)
    return (y * p["scale"].to(torch.float32).reshape(c)
            + p["bias"].to(torch.float32).reshape(c)).to(x.dtype)


def resnet_forward(cfg: ResNetConfig, params: dict, images: torch.Tensor,
                   labels: torch.Tensor, group=None):
    """images: [B, H, W, 3]; labels: [B] -> (loss, logits).  ``group``: the
    process group whose ranks hold the rest of the batch (batch-norm
    statistics are summed over it; the loss is this rank's mean)."""
    x = images.to(DTYPES[cfg.dtype]).permute(0, 3, 1, 2)
    if x.device.type == "cpu":
        # oneDNN's backward of a 1x1 stride-2 convolution of a channels-last
        # input corrupts the heap (PyTorch 2.13 on the CPU): NCHW there
        x = x.contiguous()
    x = _conv(x, params["stem"]["conv"], stride=2)
    x = F.relu(_bn(x, params["stem"]["bn"], group))
    x = _max_pool(x)
    for si in range(len(cfg.stage_sizes)):
        stage = params[f"stage{si}"]
        for bi in range(cfg.stage_sizes[si]):
            blk = stage[f"block{bi}"]
            stride = 2 if (bi == 0 and si > 0) else 1
            identity = x
            if cfg.block == "bottleneck":
                y = F.relu(_bn(_conv(x, blk["conv1"]), blk["bn1"], group))
                y = F.relu(_bn(_conv(y, blk["conv2"], stride), blk["bn2"],
                               group))
                y = _bn(_conv(y, blk["conv3"]), blk["bn3"], group)
            else:
                y = F.relu(_bn(_conv(x, blk["conv1"], stride), blk["bn1"],
                               group))
                y = _bn(_conv(y, blk["conv2"]), blk["bn2"], group)
            if "proj" in blk:
                identity = _bn(_conv(x, blk["proj"], stride),
                               blk["proj_bn"], group)
            x = F.relu(y + identity)
            if cfg.block_barriers:
                x = barrier(x)
    x = x.mean(dim=(2, 3))
    logits = x.to(torch.float32) @ params["head"].to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    return torch.mean(lse - gold), logits


# --------------------------------------------------------------------------
# the train step and its export
# --------------------------------------------------------------------------

def _value_and_grad(cfg: ResNetConfig, params: dict, images, labels,
                    group=None, gather=None):
    """The loss and its gradient tree; with ``gather`` (a data mesh's
    ``DataParallel.gather``) ``params`` are the rank's shards."""
    leaves = trainable(params)
    loss, _ = resnet_forward(cfg, gather(leaves) if gather else leaves,
                             images, labels, group)
    grads = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def make_resnet_train_step(cfg: ResNetConfig, opt_cfg=None, *, mesh=None):
    """``step(params, opt_state, images, labels) -> (params, opt_state,
    loss)``, the reference's ResNet train step: the loss and its gradient,
    then the optimizer (AdamW by default; f32 moments, each update cast
    back to its parameter's dtype).

    With a ``mesh`` (a data mesh) the step is one rank's program: it takes
    the rank's shards of the parameters and the optimizer state and its
    images, gathers the parameters, sums the batch-norm statistics over the
    data group (forward and backward), all-reduces the loss and
    reduce-scatters the gradients as means over the ranks, and updates its
    shards with the clip's norm taken over all of them."""
    opt_cfg = opt_cfg or OptimizerConfig()
    _, update_fn = make_optimizer(opt_cfg)
    if mesh is None:
        def step(params, opt, images, labels):
            loss, grads = _value_and_grad(cfg, params, images, labels)
            params, opt, _ = update_fn(params, grads, opt, opt_cfg)
            return params, opt, loss
        return step

    if opt_cfg.name != "adamw":
        raise NotImplementedError(
            "a data mesh's step takes AdamW; sharded Adafactor (whose "
            "factored moments reduce over sharded dims) is not ported yet "
            "(ROADMAP, Queue 1 item 10: Adafactor and gradient compression "
            "on shards)")
    for axis in ("pod", "model"):
        if axis_sizes(mesh).get(axis, 1) > 1:
            raise NotImplementedError(
                f"a ResNet step on a {axis!r} axis above 1: its batch-norm "
                "statistics are synchronised over the data axis only "
                "(ROADMAP, Queue 1 item 10: ResNet on the model and pod "
                "axes)")
    dp = DataParallel(resnet_specs(cfg), mesh)

    def rank_step(shards, opt, images, labels):
        loss, grads = _value_and_grad(cfg, shards, images, labels, dp.group,
                                      dp.gather)
        loss, grads = dp.mean(loss), dp.reduce_grads(grads)
        shards, opt, _ = update_fn(shards, grads, opt, opt_cfg,
                                   global_norm=dp.global_norm)
        return shards, opt, loss
    return rank_step


def resnet_input_specs(batch: int, img: int, mesh=None):
    """Meta tensors for one step's f16 NHWC images and int32 labels; with a
    mesh, the rank's rows of them (``batch`` over ``data``)."""
    def meta(shape, dtype, axes):
        if mesh is not None:
            shape = shard_shape(shape, act_sharding(axes, mesh, None, shape),
                                mesh)
        return torch.empty(shape, dtype=dtype, device="meta")

    return (meta((batch, img, img, 3), torch.float16,
                 ("batch", "seq", "seq", "embed")),
            meta((batch,), torch.int32, ("batch",)))


def resnet_train_exports(cfg: ResNetConfig, batch: int, img: int, mesh=None,
                         opt_cfg=None):
    """The ResNet train step and meta tensors standing for its arguments,
    for :func:`repro_torch.core.pipeline.export_workload`: the counterpart
    of the reference's ``resnet_train_exports``.  Returns ``(step,
    (params_abs, opt_abs, images_abs, labels_abs))``; nothing is allocated.

    With a ``mesh`` the step is one rank's program
    (:func:`make_resnet_train_step`) and the meta tensors are the rank's
    shards and images.  ``batch`` is the global batch either way."""
    opt_cfg = opt_cfg or OptimizerConfig()
    specs = resnet_specs(cfg)
    return make_resnet_train_step(cfg, opt_cfg, mesh=mesh), (
        abstract_params(specs, mesh), opt_state_abstract(specs, opt_cfg.name,
                                                         mesh),
        *resnet_input_specs(batch, img, mesh))
