#!/usr/bin/env python3
"""Launch-shape sweeps of the port's split-K decode kernel (K2 over the
contiguous cache, K3 over the paged pool) and of its LayerNorm kernels (K1
forward, K4 backward) on one NVIDIA GPU.

    python3 kernel_sweep.py [--json PATH]

Run from the root of a checkout, after or without chip_smoke.py (it
builds the kernels it needs the same way). At chip_smoke.py's phase-8
inputs it times, with chip_smoke's CUDA-graph timer (inputs cycled past
the 50 MB L2):
  - K2 and K3 at lm-base serving's cache and pool (8 slots, 16 heads of
    64, 513 keys a slot or pages of 16, phase 8's lengths, bf16 q over the
    f32 cache) with 16, 32 and 64 keys a split, the geometry's own choice
    among them; then K2 and K3 on the same keys (the pool holding K2's
    cache page by page, no page shared), in turns;
  - K1 at lm-base's (4096, 1024) and lm-xxl-fsdp's (8192, 4096) bf16 rows
    with one warp a row of 32 elements a thread (K4's layout; passes over
    the row at width 4096) and with the geometry's own layout (four warps
    a row, 8 or 32 a thread), each at 1, 2 and as many CTAs an SM as fit
    (the wrapper's choice);
  - K4 at the same rows with 1 CTA an SM and with as many as fit;
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
    from flexflow_tpu_torch.search.machine_model import card_line

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    card = card_line()
    print(card, flush=True)
    cs.build_kernels()

    def per_kernel_ms(fn, calls=16):
        numbers, _ = cs.profiled(lambda: [fn() for _ in range(calls)])
        return {t["kernel"]: t["ms"] / calls for t in numbers["top"]}

    def check(name, got, want):
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            cs.require(torch.allclose(a.float(), b.float(),
                                      **cs.TOL["bfloat16"]),
                       f"{name} disagrees with its plain version")

    def sweep(module, attr, variants, fn, sets, plain, label):
        """Time `fn` over `sets` with `module.attr` (a geometry function)
        replaced by each of `variants` ({name: function}, None for the
        module's own); returns the rows."""
        own = getattr(module, attr)
        rows = []
        try:
            for name, geometry in variants.items():
                setattr(module, attr, geometry or own)
                check(f"{label} {name}", fn(*sets[0]), plain)
                row = {"variant": name, "chosen": geometry is None,
                       "ms": cs.time_ms(fn, sets)[0],
                       "per_kernel_ms": per_kernel_ms(lambda: fn(*sets[0]))}
                rows.append(row)
                print(f"{label} {name}{' (chosen)' * row['chosen']}: "
                      f"{row['ms']:.5f} ms; {row['per_kernel_ms']}",
                      flush=True)
        finally:
            setattr(module, attr, own)
        return rows

    out = {"card": card}
    heads = cs.HEADS
    for key, attr, make, call, plain in (
            ("k2", "decode_split_geometry", cs.decode_inputs,
             fa.flash_decode_attention, fa.decode_attention_plain),
            ("k3", "paged_decode_geometry", cs.paged_inputs,
             fa.paged_flash_decode_attention,
             fa.paged_decode_attention_plain)):
        sets = [make(dev, bf16, cs.SEED + 20 + i) for i in range(4)]
        own = getattr(fa, attr)

        def fixed(kps):
            if attr == "paged_decode_geometry":
                return lambda slots, h, W, bs, hd: fa._split_geometry(
                    slots, h, W * bs, kps, hd)
            return lambda slots, h, S, hd: fa._split_geometry(
                slots, h, S, kps, hd)

        q0, c0 = sets[0][0], sets[0][1]
        shape = ((q0.shape[0], heads, sets[0][3].shape[1], c0.shape[1])
                 if key == "k3" else (q0.shape[0], heads, c0.shape[1]))
        mine = own(*shape, q0.shape[2] // heads).keys_per_split
        variants = {f"{kps} keys a split": None if kps == mine else fixed(kps)
                    for kps in (16, 32, 64)}
        out[key] = sweep(fa, attr, variants,
                         lambda *a, call=call: call(*a, num_heads=heads),
                         sets, plain(*sets[0], num_heads=heads), key.upper())
        del sets

    # K3 over a pool that holds K2's cache page by page (no page shared
    # between slots, as phase 8's pool shares slot 6's pages): the same
    # keys and bytes on both layouts, timed in turns
    sets_c, sets_p = [], []
    for i in range(4):
        q, k, v, lens = cs.decode_inputs(torch.device("cpu"), bf16,
                                         cs.SEED + 20 + i)
        pk, pv, table = cs.pooled(k, v, lens, cs.BLOCK, cs.SEED + 50 + i)
        sets_c.append(tuple(t.to(dev) for t in (q, k, v, lens)))
        sets_p.append(tuple(t.to(dev) for t in (q, pk, pv, table, lens)))

    def k2(*a):
        return fa.flash_decode_attention(*a, num_heads=heads)

    def k3(*a):
        return fa.paged_flash_decode_attention(*a, num_heads=heads)

    check("K3 over K2's keys", k3(*sets_p[0]), k2(*sets_c[0]))
    out["same_keys"] = [{"k2_ms": cs.time_ms(k2, sets_c)[0],
                         "k3_ms": cs.time_ms(k3, sets_p)[0]}
                        for _ in range(2)]
    out["same_keys"] += [{"k3_ms": cs.time_ms(k3, sets_p)[0],
                          "k2_ms": cs.time_ms(k2, sets_c)[0]}
                         for _ in range(2)]
    print(f"K2 and K3 on the same keys: {out['same_keys']}", flush=True)
    del sets_c, sets_p

    def ln_geometry(wpr, ept, per_sm):
        def geometry(n, d, itemsize, sms, ctas):
            rows = 4 // wpr
            grid = max(1, min(sms * (per_sm or ctas), -(-n // rows)))
            return ln.LayerNormFwdGeometry(wpr, ept, d > 32 * wpr * ept,
                                           grid, rows)
        return geometry

    out["k1"], out["k4"] = {}, {}
    for rows, width, n_sets in ((4096, 1024, 8), (8192, 4096, 2)):
        shape = f"({rows}, {width})"
        sets = [cs.ln_inputs(dev, bf16, rows, cs.SEED + 40 + i, width)
                for i in range(n_sets)]
        own = ln.layer_norm_fwd_geometry(rows, width, 2, 1, 1)
        layouts = ((1, 32), (own.warps_per_row, own.ept))
        variants = {
            f"{wpr} warp(s) a row of {ept} a thread, "
            f"{per_sm or 'as many as fit'} CTAs an SM":
                None if (wpr, ept, per_sm) == (own.warps_per_row, own.ept,
                                               None)
                else ln_geometry(wpr, ept, per_sm)
            for wpr, ept in layouts for per_sm in (1, 2, None)}
        out["k1"][shape] = sweep(
            ln, "layer_norm_fwd_geometry", variants,
            lambda x, s, b: ln.layer_norm(x, s, b, 1e-5), sets,
            ln.layer_norm_plain(*sets[0], 1e-5), f"K1 {shape}")
        del sets
        sets = [cs.ln_bwd_inputs(dev, bf16, rows, width, cs.SEED + 30 + i)
                for i in range(min(n_sets, 4))]
        bwd = ln.layer_norm_bwd_geometry

        def one_per_sm(n, d, itemsize, sms, ctas):
            return bwd(n, d, itemsize, sms, 1)

        out["k4"][shape] = sweep(
            ln, "layer_norm_bwd_geometry",
            {"1 CTA an SM": one_per_sm, "as many CTAs an SM as fit": None},
            lambda x, s, dy: ln.layer_norm_bwd(x, s, dy, 1e-5), sets,
            ln.layer_norm_bwd_plain(*sets[0], 1e-5), f"K4 {shape}")
        del sets
        torch.cuda.empty_cache()
    out["ctas_per_sm_fit"] = {str(k): v for k, v in ln._OCCUPANCY.items()}
    if json_path:
        os.makedirs(os.path.dirname(os.path.abspath(json_path)),
                    exist_ok=True)
        with open(json_path, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
