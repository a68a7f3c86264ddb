#!/usr/bin/env python3
"""Launch-shape sweeps of the port's K3 (split-K paged decode) and K4
(LayerNorm backward) kernels on one NVIDIA GPU.

    python3 kernel_sweep.py [--json PATH]

Run from the root of a checkout, after or without chip_smoke.py (it
builds the kernels it needs the same way). At chip_smoke.py's phase-8
inputs it times, with chip_smoke's CUDA-graph timer (inputs cycled past
the 50 MB L2):
  - K3 at lm-base serving's pool (8 slots, 16 heads of 64, pages of 16,
    phase 8's lengths, bf16 q over the f32 pool) with 16, 32 and 64 keys
    a split, the geometry's own choice among them;
  - K4 at lm-base's (4096, 1024) and lm-xxl-fsdp's (8192, 4096) bf16 rows
    with 1 CTA an SM and with as many as fit (the wrapper's choice);
and, for each, the device time of each kernel one call launches (K4's
rows kernel and its column sum) from torch.profiler. Each case is also
held against the kernel's plain version (chip_smoke's bf16 tolerance).
It exits non-zero without a CUDA device. The last line is one JSON object
of every number, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.abspath(__file__))


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", default="", help="also write the numbers "
                        "to this file")
    json_path = parser.parse_args(argv).json
    import torch

    if not torch.cuda.is_available():
        print("kernel_sweep: torch sees no CUDA device; this script runs "
              "only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import layer_norm as ln

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    card = cs.card_line()
    print(card, flush=True)
    cs.build_kernels()

    def per_kernel_ms(fn, calls=16):
        numbers, _ = cs.profiled(lambda: [fn() for _ in range(calls)])
        return {t["kernel"]: t["ms"] / calls for t in numbers["top"]}

    out = {"card": card, "k3": [], "k4": []}
    sets = [cs.paged_inputs(dev, bf16, cs.SEED + 20 + i) for i in range(4)]
    heads = cs.HEADS
    chosen = fa.paged_decode_geometry
    q0, pk0, _, table0, _ = sets[0]
    own = chosen(q0.shape[0], heads, table0.shape[1], pk0.shape[1],
                 q0.shape[2] // heads).keys_per_split
    want = fa.paged_decode_attention_plain(*sets[0], num_heads=heads)
    try:
        for kps in (16, 32, 64):
            def geometry(slots, h, W, bs, hd, kps=kps):
                splits = -(-(W * bs) // kps)
                return fa.PagedDecodeGeometry(
                    kps, splits, (splits, h, slots),
                    (slots, h, splits, hd + 2), slots * h)

            fa.paged_decode_geometry = geometry

            def call(*a):
                return fa.paged_flash_decode_attention(*a, num_heads=heads)

            got = call(*sets[0])
            torch.cuda.synchronize()
            cs.require(torch.allclose(got.float(), want.float(),
                                      **cs.TOL["bfloat16"]),
                       f"K3 at {kps} keys a split disagrees")
            row = {"keys_per_split": kps, "chosen": kps == own,
                   "ms": cs.time_ms(call, sets)[0],
                   "per_kernel_ms": per_kernel_ms(lambda: call(*sets[0]))}
            out["k3"].append(row)
            print(f"K3 {kps} keys a split{' (chosen)' * row['chosen']}: "
                  f"{row['ms']:.5f} ms", flush=True)
    finally:
        fa.paged_decode_geometry = chosen
    del sets

    layout = ln.layer_norm_bwd_geometry
    try:
        for rows, width, n_sets in ((4096, 1024, 4), (8192, 4096, 2)):
            sets = [cs.ln_bwd_inputs(dev, bf16, rows, width,
                                     cs.SEED + 30 + i)
                    for i in range(n_sets)]
            plain = ln.layer_norm_bwd_plain(*sets[0], 1e-5)
            for per_sm in (1, None):
                def geometry(n, d, itemsize, sms, ctas, per_sm=per_sm):
                    return layout(n, d, itemsize, sms, per_sm or ctas)

                ln.layer_norm_bwd_geometry = geometry

                def call(x, s, dy):
                    return ln.layer_norm_bwd(x, s, dy, 1e-5)

                got = call(*sets[0])
                torch.cuda.synchronize()
                for a, b in zip(got, plain):
                    cs.require(torch.allclose(a.float(), b.float(),
                                              **cs.TOL["bfloat16"]),
                               f"K4 ({rows}, {width}) disagrees")
                row = {"shape": [rows, width],
                       "ctas_per_sm": per_sm or "as many as fit",
                       "ms": cs.time_ms(call, sets)[0],
                       "per_kernel_ms": per_kernel_ms(
                           lambda: call(*sets[0]))}
                out["k4"].append(row)
                print(f"K4 ({rows}, {width}), CTAs an SM "
                      f"{row['ctas_per_sm']}: {row['ms']:.5f} ms; "
                      f"{row['per_kernel_ms']}", flush=True)
            del sets, plain
            torch.cuda.empty_cache()
    finally:
        ln.layer_norm_bwd_geometry = layout
    out["k4_ctas_per_sm_fit"] = {str(k): v for k, v in ln._OCCUPANCY.items()}
    if json_path:
        os.makedirs(os.path.dirname(os.path.abspath(json_path)),
                    exist_ok=True)
        with open(json_path, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
