#!/usr/bin/env python3
"""Why fig11's mixed-cocossim rows equal its roofline rows, on the CPU:

    PYTHONPATH=src python3 tools/systolic_share.py [workload ...]

Exports each named workload of ``specs/fig11_tpu.json`` (default:
``llama3-100m``) with the port on fake CPU tensors, splits its optimized
(per-rank) text with the linear slicer, and prints for the regions with
the most FLOPs the region's FLOPs, the matmul share that
``SystolicEstimator.supports`` sees (it walks ``op.regions`` only) and the
share with the ops of each ``call``'s callee counted as well.  The mixed
estimator takes a region to the systolic model only when the first share
reaches 0.9; otherwise it falls back to roofline.
"""
import sys

from repro_torch.campaign.builders import build_workload
from repro_torch.campaign.spec import CampaignSpec
from repro_torch.core.estimators.systolic import SystolicEstimator
from repro_torch.core.ir import parse_stablehlo
from repro_torch.core.ir.arrays import gemm_dims
from repro_torch.core.slicing.linear import linear_split

THRESHOLD = 0.9


def matmul_flops_with_callees(op, program) -> float:
    dims = gemm_dims(op)
    if dims is not None:
        b, m, n, k = dims
        return 2.0 * b * m * n * k
    subs = [sub for region in op.regions for sub in region]
    if not op.regions:
        for callee in op.called:
            subs += program.resolve(callee) or []
    return sum(matmul_flops_with_callees(s, program)
               for s in subs) * max(op.trip_count, 1)


def main(names: list[str]) -> None:
    spec = CampaignSpec.from_json("specs/fig11_tpu.json")
    for name in names or ["llama3-100m"]:
        ws = next(w for w in spec.workloads if w.name == name)
        program = parse_stablehlo(build_workload(ws, device="cpu").hlo_text)
        regions = [s.region for s in linear_split(program)
                   if s.region is not None and s.region.cost.flops > 0]
        rows = sorted(((r.cost.flops,
                        sum(SystolicEstimator._matmul_flops(o)
                            for o in r.ops),
                        sum(matmul_flops_with_callees(o, program)
                            for o in r.ops)) for r in regions),
                      reverse=True)
        print(f"{name} on {ws.mesh}: {len(rows)} regions with FLOPs")
        for total, mat, with_callees in rows[:3]:
            print(f"  {total:.6e} FLOPs: systolic's matmul share "
                  f"{mat / total:.4f}, with callees "
                  f"{with_callees / total:.4f}")
        print(f"  regions at or above {THRESHOLD}: "
              f"{sum(m / t >= THRESHOLD for t, m, _ in rows)} as systolic "
              f"sees them, {sum(c / t >= THRESHOLD for t, _, c in rows)} "
              "with callees")


if __name__ == "__main__":
    main(sys.argv[1:])
