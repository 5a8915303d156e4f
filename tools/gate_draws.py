#!/usr/bin/env python3
"""How much does phase 15's gradient gate on mamba2-370m depend on the
draw of the weights, and do the kernels agree with their plain versions
on a draw where it fails?  On one H100:

    python3 tools/gate_draws.py [--state HEX] [--seeds N] [--families]
                                [--cuts 2,4,...]

Each draw takes mamba2-370m's weights at full width and depth (48 layers)
with the reference's init from a CUDA generator: first at ``--state`` (a
``torch.Generator.get_state()`` written in hex) when given, then seeded
0..N-1 (N 6 by default).  It takes the six AdamW steps that
``chip_smoke.train_family`` takes on phase 15's 4 x 2048 batch before its
gate, and prints:

- the gate at the reference init: the five parameters with the largest
  ratio of the kernel path's distance from an f32 plain run to the plain
  bf16 path's (kernel / plain = ratio; the gate holds each ratio at 2),
  and the range of the kernel path's distances;
- whether the kernel path's gradients are equal bits twice;
- on the first run at ``--state`` and on seed 0, every K3, K3b, K2 and K2b
  launch of that gradient held against the exact result with phase 3's
  measures (the largest element and row error over the launches, in units
  of the tolerance), beside its plain version on the same inputs;
- the same model with its weights redrawn at fan-in init
  (``chip_smoke.fan_in_init``): the gate again, and with ``--cuts`` on the
  seeded draws also on each count of first layers given.

With ``--state`` the whole draw runs twice, and the two runs' parameters
and gate distances are compared bit for bit.  With ``--families`` the gate
at fan-in init also runs on a fresh draw of each other id of phase 15.
"""
import argparse
import contextlib
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import chip_smoke as c  # noqa: E402


@contextlib.contextmanager
def witnessed(worst: dict):
    """Each launch of K3 (writing its states), K3b, K2 and K2b held against
    the exact result (phase 3's measures, in units of the tolerance), and
    its plain version on the same inputs beside it: {kernel: (largest
    element and row error of the kernel, the same of the plain version,
    launches)} into ``worst``."""
    k3_call, k2_call = c.k3_ops.call, c.k2_ops.call

    def note(kernel, errs, plain_errs):
        old = worst.get(kernel, (0.0,) * 4 + (0,))
        worst[kernel] = (*(max(u, v) for u, v in zip(
            old[:4], (*errs, *plain_errs))), old[4] + 1)

    def k3(op, *args):
        out = k3_call(op, *args)
        if op is c.k3_ops._SCAN_STATES:
            x, dt, a, b_in, c_in, chunk, init = args
            note("K3", *(c.ssd_error(y, final, x, dt, a, b_in, c_in, chunk,
                                     init, states)[1:]
                         for y, final, states in (
                             out, c.k3_ops.ssd_scan_states_ref(*args))))
        elif op is c.k3_ops._BWD:
            x, dt, a, b_in, c_in, chunk, init, _, dy, dfinal = args
            note("K3b", *((max(e[1] for e in errs), max(e[2] for e in errs))
                          for errs in (c.k3b_error(
                              g, x, dt, a, b_in, c_in, chunk, init,
                              dy.to(x.dtype), dfinal) for g in (
                                  out, c.k3_ops.ssd_scan_bwd_ref(*args)))))
        return out

    def k2(op, *args):
        out = k2_call(op, *args)
        if op is c.k2_ops._FWD:
            note("K2", *((c.rmsnorm_error(y, *args)[1], 0.0) for y in (
                out, c.k2_ops.rmsnorm_ref(*args))))
        elif op is c.k2_ops._BWD:
            note("K2b", *((max(e[1], e[4]), e[2]) for e in (
                c.k2b_error(*g, *args) for g in (
                    out, c.k2_ops.rmsnorm_bwd_ref(*args)))))
        return out

    c.k3_ops.call, c.k2_ops.call = k3, k2
    try:
        yield
    finally:
        c.k3_ops.call, c.k2_ops.call = k3_call, k2_call


def trained(cfg, gen, batch):
    """The weights drawn from ``gen`` after train_family's six steps (its
    warm-up, its counted steps and its profiled one)."""
    params = c.init_params(c.model_specs(cfg), gen, "cuda")
    opt_cfg = c.OptimizerConfig(warmup_steps=1)
    opt = c.adamw_init(params, opt_cfg)
    step = c.make_train_step(cfg, opt_cfg, donate=True)
    for _ in range(c.FAMILY_WARMUP + c.FAMILY_STEPS + 1):
        params, opt, metrics = step(params, opt, batch)
    return params, float(metrics["loss"])


def summary(rows: dict) -> str:
    top = sorted(rows.items(), key=lambda r: -r[1][0] / r[1][1])[:5]
    ks = [k for k, _ in rows.values()]
    return (f"kernel distances {min(ks):.3e}..{max(ks):.3e}; " + "; ".join(
        f"{n} {k:.3e}/{p:.3e}={k / p:.2f}" for n, (k, p) in top))


def mamba_draw(label, cfg, gen, batch, witness: bool, cuts=()) -> tuple:
    params, loss = trained(cfg, gen, batch)
    rows = c.gate_distances(cfg, params, batch)
    print(f"{label}: loss {loss:.4f}; reference init: {summary(rows)}",
          flush=True)
    worst = {}
    with witnessed(worst) if witness else contextlib.nullcontext():
        g1 = c.flatten(c.masked_grads(cfg, params, batch))
    g2 = c.flatten(c.masked_grads(cfg, params, batch))
    same = all(torch.equal(g1[n], g2[n]) for n in g1)
    print(f"{label}: kernel gradients equal bits twice: {same}" + (
        "; each launch against the exact result, kernel beside plain "
        "version (largest element and row error in units of the "
        "tolerance; launches): " + "; ".join(
            f"{k} {e:.3f} {r:.3f}, plain {pe:.3f} {pr:.3f} ({n})"
            for k, (e, r, pe, pr, n) in sorted(worst.items()))
        if witness else ""), flush=True)
    del g1, g2
    c.fan_in_init(c.model_specs(cfg), params, gen)
    fan = c.gate_distances(cfg, params, batch)
    print(f"{label}: fan-in init: {summary(fan)}", flush=True)
    for cut in cuts:
        rows = c.gate_distances(cfg.scaled(num_layers=cut), dict(
            params, layers=c.tree_map(params["layers"], lambda t: t[:cut])),
            batch)
        print(f"{label}: fan-in init, the first {cut} layers: "
              f"{summary(rows)}", flush=True)
    flat = {n: t.clone() for n, t in c.flatten(params).items()}
    del params
    torch.cuda.empty_cache()
    return flat, rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--state", help="a CUDA generator state in hex")
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--families", action="store_true")
    ap.add_argument("--cuts", default="",
                    help="comma-separated layer counts: the fan-in gate "
                    "again on each draw's first layers")
    args = ap.parse_args()
    c._build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(c.card(), flush=True)
    cfg = c.get_config("mamba2-370m")
    batch = {k: torch.from_numpy(x).cuda() for k, x in next(c.SyntheticSource(
        c.DataConfig(vocab_size=cfg.vocab_size, seq_len=2048, global_batch=4,
                     seed=0))).items()}
    if args.state:
        state = torch.frombuffer(bytearray.fromhex(args.state),
                                 dtype=torch.uint8).clone()
        runs = []
        for i in range(2):
            gen = torch.Generator(device="cuda")
            gen.set_state(state)
            runs.append(mamba_draw(f"state run {i + 1}", cfg, gen, batch,
                                   witness=i == 0))
        (p1, r1), (p2, r2) = runs
        print("state: the two runs' parameters equal bits: "
              f"{all(torch.equal(p1[n], p2[n]) for n in p1)}; gate "
              f"distances equal: {r1 == r2}", flush=True)
        del runs, p1, p2
        torch.cuda.empty_cache()
    for seed in range(args.seeds):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        mamba_draw(f"seed {seed}", cfg, gen, batch, witness=seed == 0,
                   cuts=[int(x) for x in args.cuts.split(",") if x])
        torch.cuda.empty_cache()
    if args.families:
        for arch, layers, b, s, remat in c.FAMILY_TRAIN[1:]:
            fcfg = c.get_config(arch).scaled(num_layers=layers, remat=remat)
            if fcfg.family == "hybrid":
                fcfg = fcfg.scaled(num_layers=c.GATE_SUPER_BLOCKS
                                   * fcfg.hybrid_attn_every)
            gen = torch.Generator(device="cuda").manual_seed(0)
            specs = c.model_specs(fcfg)
            params = c.init_params(specs, gen, "cuda")
            fbatch = {k: torch.from_numpy(x).cuda() for k, x in next(
                c.SyntheticSource(c.DataConfig(
                    vocab_size=fcfg.vocab_size, seq_len=s, global_batch=b,
                    seed=0))).items()}
            for init in ("reference", "fan-in"):
                if init == "fan-in":
                    c.fan_in_init(specs, params, gen)
                try:
                    rows = c.gate_distances(fcfg, params, fbatch)
                    print(f"{arch} ({fcfg.num_layers} layers) {init} init: "
                          f"{summary(rows)}", flush=True)
                except AssertionError as e:
                    print(f"{arch} {init} init: {e}", flush=True)
            del params, fbatch
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
