"""The port's CUDA kernels against their plain versions on the card: K1
(flash attention), K2 (RMSNorm) and K3 (the SSD scan), each at a few shapes
and layouts of the serving paths, and K1's log-sum-exp, K1b and K2b (their
backwards) and the gradients of a small model through them, in f32 and
bf16, with the tolerances of each kernel's ``ref.py``.  Every test is marked ``cuda`` and skips
without a card.  The file imports neither JAX nor the JAX package, so it
also runs on a machine with a card and no JAX:

    python -m pytest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as k1_ops
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bwd)
from repro_torch.kernels.flash_attention.ref import (
    bwd_kernel_error as k1b_error, kernel_error as flash_error, lse_error)
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_bwd
from repro_torch.kernels.rmsnorm.ref import (
    bwd_kernel_error as k2b_error, kernel_error as rmsnorm_error,
    rmsnorm_ref)
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import kernel_error as ssd_error
from repro_torch.models import common as model_common
from repro_torch.models.params import init_params
from repro_torch.models.registry import get_smoke_config
from repro_torch.models.transformer import model_specs
from repro_torch.train.checkpoint import _flatten
from repro_torch.train.loop import _value_and_grad
from repro_torch.train.optimizer import tree_leaves, tree_map


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _qkv(seed, b, hq, hkv, sq, skv, d):
    return _normal(seed, (b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))


def _ssd_inputs(seed, b, s, h, p, g, n):
    """x, dt (softplus of a normal), a (negative), B, C and an initial
    state, as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x, bi, ci, st0 = (rng.standard_normal(shape).astype(np.float32)
                      for shape in ((b, s, h, p), (b, s, g, n), (b, s, g, n),
                                    (b, h, p, n)))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    return x, dt, a, bi, ci, st0


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
            for a in arrays]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window,cap,q_offset,bshd", [
    (2, 8, 2, 256, 256, 64, True, 0, 0.0, 0, False),
    (2, 8, 2, 1024, 1024, 64, True, 0, 0.0, 0, True),
    (1, 4, 4, 200, 200, 32, True, 48, 0.0, 0, False),
    (1, 8, 2, 100, 356, 128, True, 0, 30.0, 256, False),
    (2, 4, 2, 130, 70, 64, False, 0, 0.0, 0, False),
    # across the bf16 kernel's 128-row query items and 128-key tiles (64
    # keys at d=128) and its ring of stages: ragged Sq and Skv
    (2, 8, 2, 1, 300, 64, True, 0, 0.0, 299, False),
    (2, 8, 2, 127, 333, 64, True, 0, 0.0, 0, False),
    (2, 8, 2, 129, 200, 64, False, 0, 0.0, 0, False),
    (1, 8, 2, 1000, 1111, 64, True, 0, 0.0, 111, False),
    # a window edge inside a tile; q_offset with Sq < Skv
    (1, 8, 2, 700, 700, 64, True, 100, 0.0, 0, False),
    (1, 8, 2, 300, 812, 64, True, 0, 0.0, 512, False),
    # group 1 and group 8
    (1, 8, 8, 256, 256, 64, True, 0, 0.0, 0, False),
    (1, 16, 2, 256, 256, 64, True, 0, 0.0, 0, False),
    # d 32, 64 and 128 in the strided [B, S, H, D] layout
    (2, 8, 2, 384, 384, 32, True, 0, 0.0, 0, True),
    (1, 8, 2, 1000, 1000, 64, True, 0, 0.0, 0, True),
    (1, 8, 2, 520, 520, 128, True, 0, 0.0, 0, True),
])
def test_flash_kernel_on_card(cuda, dtype, b, hq, hkv, sq, skv, d, causal,
                              window, cap, q_offset, bshd):
    # bshd: [B, S, H, D] tensors seen as [B, H, S, D], as gqa_forward passes
    # its projections; the tolerances are ref.RTOL and ref.ROW_RTOL
    q, k, v = _qkv(8, b, hq, hkv, sq, skv, d)
    if bshd:
        q, k, v = (np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                   for a in (q, k, v))
    q, k, v = (t.to(cuda) for t in _torch([q, k, v], dtype))
    if bshd:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    kw = dict(causal=causal, window=window, logit_cap=cap, q_offset=q_offset)
    before = flash_attention.launches
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _, elem, row = flash_error(out, q, k, v, **kw)
    assert elem <= 1.0 and row <= 1.0, (elem, row)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d,offset", [(8192, 2048, 0.0), (8, 2048, 0.0),
                                           (8192, 1024, 0.0), (8, 4096, 0.0),
                                           (37, 1001, 1.0)])
def test_rmsnorm_kernel_on_card(cuda, dtype, rows, d, offset):
    x, w = _normal(9, (rows, d), (d,))
    x, w = (t.to(cuda) for t in _torch([x, 1.0 + 0.1 * w], dtype))
    before = rmsnorm.launches
    out = rmsnorm(x, w, offset=offset)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    # the tolerance is the rmsnorm ref.RTOL, relative to each element
    _, elem = rmsnorm_error(out, x, w, offset=offset)
    assert elem <= 1.0, elem


@pytest.mark.cuda
def test_a_graph_capture_is_not_a_counted_launch(cuda):
    """A call captured into a CUDA graph records K2 and is not counted, and
    the graph's replays launch it without the wrapper; the replay's output
    is the eager call's."""
    x, w = _normal(9, (64, 2048), (2048,))
    x, w = (t.to(cuda) for t in _torch([x, 1.0 + 0.1 * w], torch.float32))
    want = rmsnorm(x, w)
    before = rmsnorm.launches
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = rmsnorm(x, w)
    graph.replay()
    torch.cuda.synchronize()
    assert rmsnorm.launches == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk,strided,init", [
    (2, 512, 8, 64, 1, 128, 256, False, False),
    (2, 512, 8, 64, 1, 128, 256, True, True),
    (1, 256, 8, 64, 2, 32, 64, True, False),
    (2, 384, 4, 32, 1, 64, 128, False, True),
    # L = 192 (three i tiles), and 16 chunks of recurrence
    (1, 768, 4, 64, 1, 128, 192, True, True),
    (1, 1024, 2, 32, 1, 32, 64, False, True),
])
def test_ssd_kernel_on_card(cuda, dtype, b, s, h, p, g, n, chunk, strided,
                            init):
    # the whole scan, one launch: y and the final state against the plain
    # scan.  strided: x, B and C as column slices of one [B, S, H*P + 2*G*N]
    # tensor, as mamba2_forward passes them; the tolerances are
    # ref.RTOL, ROW_RTOL and STATE_ROW_RTOL
    x, dt, a, bi, ci, st0 = _ssd_inputs(20, b, s, h, p, g, n)
    if strided:
        xbc = np.concatenate([x.reshape(b, s, -1), bi.reshape(b, s, -1),
                              ci.reshape(b, s, -1)], axis=-1)
        xbc = _torch([xbc], dtype)[0].to(cuda)
        tx, tbi, tci = torch.split(xbc, [h * p, g * n, g * n], dim=-1)
        tx = tx.reshape(b, s, h, p)
        tbi, tci = tbi.reshape(b, s, g, n), tci.reshape(b, s, g, n)
    else:
        tx, tbi, tci = (t.to(cuda) for t in _torch([x, bi, ci], dtype))
    tdt, ta, tst0 = (t.to(cuda) for t in _torch([dt, a, st0]))
    tst0 = tst0 if init else None
    before = ssd_scan.launches
    y, final = ssd_scan(tx, tdt, ta, tbi, tci, chunk=chunk,
                        initial_state=tst0)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    _, elem, row = ssd_error(y, final, tx, tdt, ta, tbi, tci, chunk, tst0)
    assert elem <= 1.0 and row <= 1.0, (elem, row)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [32, 96, 320])
def test_ssd_kernel_refuses_chunks_it_does_not_take(cuda, chunk):
    # K3 takes a chunk length that is a multiple of 64 up to 256
    x, dt, a, bi, ci, _ = _torch(_ssd_inputs(21, 1, 960, 2, 32, 1, 32))
    x, bi, ci = (t.to(cuda).bfloat16() for t in (x, bi, ci))
    with pytest.raises(ValueError):
        ssd_scan(x, dt.to(cuda), a.to(cuda), bi, ci, chunk=chunk)


# --------------------------------------------------------------------------
# the training slice: K1's log-sum-exp, K1b, K2b and gradients through them
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window,cap,q_offset", [
    (2, 8, 2, 256, 256, 64, True, 0, 0.0, 0),
    (1, 8, 2, 200, 200, 32, True, 48, 0.0, 0),
    (1, 8, 2, 100, 356, 128, True, 0, 1.0, 256),
    (2, 4, 2, 130, 70, 64, False, 0, 0.0, 0),
    (1, 16, 2, 129, 300, 64, True, 0, 0.0, 171),
    (1, 4, 2, 64, 64, 64, True, 8, 0.0, 100),   # no query sees a key
    # GQA group 4, Sq and Skv not multiples of the bf16 kernels' 128-key
    # and 128-row items: the ragged edge of both, causal and not
    (2, 16, 4, 333, 461, 64, True, 0, 0.0, 128),
    (1, 8, 2, 200, 190, 128, False, 0, 0.0, 0),
])
def test_flash_bwd_kernel_on_card(cuda, dtype, b, hq, hkv, sq, skv, d, causal,
                                  window, cap, q_offset):
    # K1 with and without lse (the output bit-identical), then K1b on K1's
    # lse; the tolerances are ref.LSE_ATOL, BWD_RTOL and BWD_ROW_RTOL
    q, k, v = (t.to(cuda) for t in _torch(_qkv(10, b, hq, hkv, sq, skv, d),
                                          dtype))
    do = _torch(_normal(11, (b, hq, sq, d)), dtype)[0].to(cuda)
    kw = dict(causal=causal, window=window, logit_cap=cap, q_offset=q_offset)
    o_null, none = k1_ops._forward(q, k, v, with_lse=False, **kw)
    o, lse = k1_ops._forward(q, k, v, with_lse=True, **kw)
    before = flash_attention_bwd.launches
    grads = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert none is None and torch.equal(o_null, o)
    assert flash_attention_bwd.launches == before + 1
    assert lse_error(lse, q, k, v, **kw)[1] <= 1.0
    for dx, x in zip(grads, (q, k, v)):
        assert dx.shape == x.shape and dx.dtype == x.dtype
    for err, elem, row in k1b_error(grads, q, k, v, o, lse, do, **kw):
        assert elem <= 1.0 and row <= 1.0, (elem, row)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d,offset", [(8192, 2048, 0.0), (8, 2048, 0.0),
                                           (4096, 1024, 1.0), (8, 4096, 0.0),
                                           (37, 1001, 1.0)])
def test_rmsnorm_bwd_kernel_on_card(cuda, dtype, rows, d, offset):
    x, w, dy = _normal(12, (rows, d), (d,), (rows, d))
    x, w, dy = (t.to(cuda) for t in _torch([x, 1.0 + 0.1 * w, dy], dtype))
    before = rmsnorm_bwd.launches
    dx, dw = rmsnorm_bwd(x, w, dy, offset=offset)
    torch.cuda.synchronize()
    assert rmsnorm_bwd.launches == before + 1
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    # the tolerances are the rmsnorm ref.BWD_RTOL, BWD_ROW_RTOL and DW_RTOL
    _, rx, rrow, _, rw = k2b_error(dx, dw, x, w, dy, offset=offset)
    assert max(rx, rrow, rw) <= 1.0, (rx, rrow, rw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_are_deterministic(cuda, dtype):
    # K1b and K2b add every sum in a fixed order (no atomics): two launches
    # on the same inputs give the same bits
    q, k, v = (t.to(cuda) for t in _torch(_qkv(15, 2, 16, 4, 700, 700, 64),
                                          dtype))
    do = _torch(_normal(16, (2, 16, 700, 64)), dtype)[0].to(cuda)
    o, lse = k1_ops._forward(q, k, v, causal=True, window=0, logit_cap=0.0,
                             q_offset=0, with_lse=True)
    first, second = (flash_attention_bwd(q, k, v, o, lse, do)
                     for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    x, w, dy = _normal(17, (4096, 2048), (2048,), (4096, 2048))
    x, w, dy = (t.to(cuda) for t in _torch([x, 1.0 + 0.1 * w, dy], dtype))
    first, second = (rmsnorm_bwd(x, w, dy) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _tiny_llama():
    # head_dim 64 (K1 takes 32, 64 and 128), GQA group 2, 2 layers
    return get_smoke_config("llama3-1b").scaled(
        d_model=256, num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=512)


@pytest.mark.cuda
def test_gradients_through_the_kernels_reach_every_parameter(cuda,
                                                             monkeypatch):
    # bf16 gradients through K1, K1b, K2 and K2b against the plain bf16 path
    # (chunked attention, plain norms), both against an f32 plain run: the
    # kernels' distance within twice the plain path's, for every parameter
    cfg = _tiny_llama()
    params = init_params(model_specs(cfg), torch.Generator(cuda).manual_seed(0),
                         cuda)
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (2, 257)).astype(np.int32)).to(cuda)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    counts = (flash_attention_bwd.launches, rmsnorm_bwd.launches)
    _, gk = _value_and_grad(cfg, params, batch)
    assert (flash_attention_bwd.launches - counts[0],
            rmsnorm_bwd.launches - counts[1]) == (2, 5)
    plain = cfg.scaled(attn_impl="chunked", attn_chunk=128)
    monkeypatch.setattr(model_common, "rmsnorm", rmsnorm_ref)
    _, gp = _value_and_grad(plain, params, batch)
    _, g32 = _value_and_grad(plain.scaled(dtype="float32"),
                             tree_map(lambda t: t.float(), params), batch)
    for (name, a), p, ref in zip(_flatten(gk).items(), tree_leaves(gp),
                                 tree_leaves(g32)):
        assert torch.isfinite(a).all() and a.abs().max() > 0, name
        dk = (a.float() - ref).norm() / ref.norm()
        dp = (p.float() - ref).norm() / ref.norm()
        assert dk <= 2 * dp, (name, dk.item(), dp.item())


@pytest.mark.cuda
def test_remat_full_recomputes_the_kernels_and_keeps_the_gradients(cuda):
    # remat="full" recomputes each layer in the backward: K1 and K2 launch
    # again there, and the gradients are bit for bit those without remat
    # (every kernel of the path is deterministic: no atomics)
    cfg = _tiny_llama()
    params = init_params(model_specs(cfg), torch.Generator(cuda).manual_seed(1),
                         cuda)
    toks = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab_size, (2, 129)).astype(np.int32)).to(cuda)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    grads, launches = [], []
    for remat in ("none", "full"):
        before = flash_attention.launches
        grads.append(_value_and_grad(cfg.scaled(remat=remat), params,
                                     batch)[1])
        launches.append(flash_attention.launches - before)
    assert launches == [cfg.num_layers, 2 * cfg.num_layers]
    for a, b in zip(tree_leaves(grads[0]), tree_leaves(grads[1])):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_ssd_scan_refuses_a_gradient_on_the_card(cuda):
    x, dt, a, bi, ci, _ = _torch(_ssd_inputs(22, 1, 256, 2, 32, 1, 32))
    x, bi, ci = (t.to(cuda).bfloat16() for t in (x, bi, ci))
    dt, a = dt.to(cuda), a.to(cuda)
    with torch.no_grad():   # no gradient asked for: K3 runs
        ssd_scan(x, dt, a, bi, ci, chunk=64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ssd_scan(x.requires_grad_(True), dt, a, bi, ci, chunk=64)


@pytest.mark.cuda
def test_export_on_the_card_launches_nothing_and_equals_the_cpu_text(cuda):
    # a trace on fake cuda tensors runs only the operators' fakes: no
    # launch, no device memory, and the same text as on the CPU
    from repro_torch.core.pipeline import export_workload
    from repro_torch.train.loop import train_step_exports

    cfg = get_smoke_config("llama3-1b")
    step, args = train_step_exports(cfg, 128, 2)
    counters = [f.launches for f in (flash_attention, flash_attention_bwd,
                                     rmsnorm, rmsnorm_bwd, ssd_scan)]
    mem = torch.cuda.memory_allocated(cuda)
    w = export_workload(step, *args, device=cuda)
    assert torch.cuda.memory_allocated(cuda) == mem
    assert [f.launches for f in (flash_attention, flash_attention_bwd,
                                 rmsnorm, rmsnorm_bwd, ssd_scan)] == counters
    n = cfg.num_layers
    assert w.meta["kernel_ops"] == {"flash_attention_lse": n,
                                    "flash_attention_bwd": n,
                                    "rmsnorm": 2 * n + 1,
                                    "rmsnorm_bwd": 2 * n + 1}
    assert w.stablehlo_text == export_workload(
        step, *args, device="cpu").stablehlo_text


_KERNELS = (flash_attention, flash_attention_bwd, rmsnorm, rmsnorm_bwd)


@pytest.mark.cuda
def test_per_rank_step_in_a_fake_world_launches_the_four_kernels(cuda):
    # one rank of a [4, 1] data mesh, eagerly on the card: its gathers move
    # no data (the fake backend), so this counts launches only
    from repro_torch.launch.mesh import traced_mesh
    from repro_torch.models.params import shard_params
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import OptimizerConfig, adamw_init

    cfg = _tiny_llama()
    specs = model_specs(cfg)
    toks = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab_size, (1, 129)).astype(np.int32)).to(cuda)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    with traced_mesh((4, 1), cuda) as mesh:
        params = shard_params(specs, init_params(
            specs, torch.Generator(cuda).manual_seed(2), cuda), mesh)
        opt_cfg = OptimizerConfig()
        step = make_train_step(cfg, opt_cfg, mesh=mesh)
        before = [f.launches for f in _KERNELS]
        step(params, adamw_init(params, opt_cfg), batch)
        torch.cuda.synchronize()
    n = cfg.num_layers
    assert [f.launches - b for f, b in zip(_KERNELS, before)] == [
        n, n, 2 * n + 1, 2 * n + 1]


def _allocations(device) -> int:
    """The card's allocator's count of allocations so far (a free does
    not lower it)."""
    return torch.cuda.memory_stats(device).get("allocation.all.allocated", 0)


@pytest.mark.cuda
def test_mesh_export_on_the_card_allocates_nothing(cuda):
    # the [4, 1] export on fake cuda tensors: the global and the per-rank
    # traces launch nothing and allocate nothing (counted around the
    # export, inside the fake world); the per-rank text is the CPU's
    from repro_torch.core.pipeline import export_workload
    from repro_torch.launch.mesh import traced_mesh
    from repro_torch.models.registry import get_config
    from repro_torch.train.loop import train_step_exports

    cfg = get_config("llama3-100m")
    step, args = train_step_exports(cfg, 128, 4)
    texts = []
    for device in (cuda, "cpu"):
        with traced_mesh((4, 1), device) as mesh:
            rank = train_step_exports(cfg, 128, 4, mesh)
            counters = [f.launches for f in _KERNELS]
            allocs = _allocations(cuda)
            w = export_workload(step, *args, device=device,
                                per_rank=(*rank, mesh))
            assert _allocations(cuda) == allocs
            assert [f.launches for f in _KERNELS] == counters
        texts.append(w.hlo_text)
    assert "mhlo.num_partitions = 4 " in texts[0]
    assert texts[0] == texts[1]
