#!/usr/bin/env python3
"""Is K1 at MLA's pair held back by re-reading K and V? On one H100:

    python3 tools/k1_kv_reuse.py

Times K1 (bf16, causal, the strided layout ``mla_forward`` passes) at the
deepseek-v3-671b prefill shape of ``chip_smoke.py``'s ``mla_bshd`` case (1
x 128 query heads x 8192 tokens, query/key 192, value 128) with 128 KV
heads, as MLA has them, and with 32 and 8: the same operations, the same
query and output bytes, and K and V 4 and 16 times fewer.  The bf16 kernel
hands its 132 persistent blocks work items with the query head varying
fastest, so at one query head a KV head the blocks running together read
132 heads' K and V (5.2 MB each at 8192 keys), more than the 50 MB L2; a
time that falls as the KV heads shrink says the kernel waits on those
reads.  SDPA (whichever backend torch picks) is timed beside each.  Prints
the card's name and power limit, then one line per case.
"""
import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import chip_smoke as cs  # noqa: E402

B, HQ, S, D, DV = 1, 128, 8192, 192, 128


def main() -> int:
    cs._build.build()
    print(cs.card(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flops = 2 * (D + DV) * cs.k1_visible_pairs(S, S, True, 0, 0) * B * HQ
    bound_ms, by = cs.bound(flops, 0, torch.bfloat16)
    for hkv in (128, 32, 8):
        q, k, v = cs.k1_inputs(gen, "kv_bshd", B, HQ, hkv, S, S, D,
                               torch.bfloat16, DV)
        ms = cs.device_ms(lambda: cs.flash_attention(q, k, v, causal=True))
        sdpa = cs.device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=hkv != HQ))
        kv_mb = (k.numel() + v.numel()) * 2 / 1e6
        print(f"K1 {B}x{HQ}/{hkv}x{S} d={D} dv={DV}: {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s, {ms / bound_ms:.2f}x the "
              f"{by} bound {bound_ms:.4f} ms), K and V {kv_mb:.1f} MB; "
              f"SDPA {sdpa:.4f} ms ({cs.sdpa_backend(q, k, v)})",
              flush=True)
        del q, k, v
    return 0


if __name__ == "__main__":
    sys.exit(main())
