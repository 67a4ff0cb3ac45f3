"""Roofline of the closest-hit traversal (K1) on the card, per bounce of the
shared workload (workload.py), and the bound function chip_smoke.py shares.

    python -m curry_pbrt_tpu_torch.tools.roofline [scenes ...] [--rays N] [--depth D] [--device cpu]

Per bounce: live lanes, entered and improved tiles (K1's stats, K1b),
K1's time by CUDA events, the f32 operations the entered tiles need and
their rate, and that rate's share of the card's peak. The output goes to
build/roofline/roofline.json (not the root roofline.json, which is an input
of the JAX package's bench.py).

The peak is derived from the card itself and printed with its derivation:
the SM count (torch.cuda.get_device_properties), the maximum SM clock
(nvidia-smi --query-gpu=clocks.max.sm) and 128 FP32 lanes per SM, one
operation per lane per clock. An FMA is not counted as two operations: the
kernels are built with -fmad=false (ops/kernels/build.py), so every
multiply and add issues on its own, and that rate is half the data sheet's
67 TFLOP/s, which counts an FMA as two. Both shares are reported.

The bound (`bound`, also used by chip_smoke.py for every kernel) is the
least time the card could take: the larger of the bytes the function must
move (live rays in, dead rays' t_max in, results out, tables once) over the
memory rate and the operations its inputs need (each entered tile's rows
and its box test) over the f32 rate, with the data sheet's rates of an
H100 SXM at 700 W.

On the CPU the tool runs the plain versions and reports counts only; every
time, rate and share is "not measured" (None).
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from curry_pbrt_tpu_torch.ops.kernels.intersect_kernel import tri_closest_hit_tables
from curry_pbrt_tpu_torch.tools.workload import Workload, load_scene

# NVIDIA's data sheet, H100 SXM at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # counts an FMA as two operations
# f32 operations per test, counted in csrc/intersect.cuh (add, sub, mul,
# div, sqrt, abs, min, max; comparisons and selects not counted)
TRI_TEST_OPS, SPHERE_TEST_OPS, BOX_TEST_OPS = 84, 73, 25
RAY_IN_BYTES = 28  # o, d (12 B each) and t_max (4 B)
T_MAX_BYTES = 4  # all a dead ray (t_max 0) needs read: its result is fixed
FP32_LANES_PER_SM = 128
OUT = Path(__file__).resolve().parents[2] / "build" / "roofline" / "roofline.json"


def bound(n_rays: int, live: int, out_bytes_per_ray: int, table_bytes: int, entered: int,
          block: int, test_ops: int):
    """(bound ms, "bytes" or "operations") of n_rays rays of which `live`
    have t_max > 0: each input byte the function needs read once (a live
    ray's o, d and t_max; a dead ray's t_max alone) and each output byte
    written once; the operations these inputs need — every entered tile's
    `block` rows at test_ops each, plus its box test (failed box tests of
    clusters, supers and slabs are not counted, so this is a lower
    bound)."""
    n_bytes = (live * RAY_IN_BYTES + (n_rays - live) * T_MAX_BYTES
               + n_rays * out_bytes_per_ray + table_bytes)
    return least_ms(n_bytes, tile_ops(entered, block, test_ops))


def least_ms(n_bytes: float, n_ops: float):
    """(ms, "bytes" or "operations"): the larger of n_bytes over the memory
    rate and n_ops f32 operations over the f32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def tile_ops(entered: int, block: int, test_ops: int = TRI_TEST_OPS) -> float:
    """f32 operations of `entered` tiles of `block` rows and their box tests."""
    return float(entered) * (block * test_ops + BOX_TEST_OPS)


def table_bytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_peak(device=0) -> dict:
    """The card's f32 rate without FMA contraction, derived from its SM
    count and maximum SM clock, with the derivation as text."""
    props = torch.cuda.get_device_properties(device)
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    peak = props.multi_processor_count * FP32_LANES_PER_SM * mhz * 1e6
    return {
        "card": nvidia_smi("name,power.limit"),
        "sms": props.multi_processor_count, "max_sm_mhz": mhz, "ops_per_s": peak,
        "derivation": (f"{props.multi_processor_count} SMs x {FP32_LANES_PER_SM} FP32 lanes x "
                       f"{mhz:.0f} MHz x 1 op/lane/clock = {peak / 1e12:.2f} Tops/s (an FMA is "
                       f"not counted as 2: the kernels build with -fmad=false); the data "
                       f"sheet's {F32_OPS_PER_S / 1e12:.0f} TFLOP/s counts an FMA as 2"),
    }


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of fn() over reps launches by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def turns(fa, fb, reps: int):
    """(ms of fa, ms of fb), each the mean of two cuda_ms runs timed in
    turns a, b, b, a: two versions compared inside one call, on one card."""
    a1, b1 = cuda_ms(fa, reps), cuda_ms(fb, reps)
    b2, a2 = cuda_ms(fb, reps), cuda_ms(fa, reps)
    return (a1 + a2) / 2, (b1 + b2) / 2


def analyze(scene_name, n_rays: int, depth: int, device="cuda", seed: int = 0, reps: int = 5,
            peak=None, wl: Workload = None) -> dict:
    """The per-bounce roofline of K1 on one scene (or on a given Workload)
    → a summary dict."""
    wl = wl or Workload(load_scene(scene_name), device)
    tb, host = wl.tables, wl.host
    on_card = wl.device.type == "cuda"
    if on_card and peak is None:
        peak = card_peak(wl.device)
    block = host.block_t
    n_clusters = int((~torch.isnan(tb.caabb[:, 0])).sum())
    rows, tot_ops, tot_ms = [], 0.0, 0.0
    n = 0
    for b in wl.bounces(n_rays, depth, seed):
        n = b.o.shape[0]
        args = (b.o, b.d, b.t_max, tb.tris16, tb.caabb, tb.saabb, tb.slab_aabb)
        _, _, entered, improved = tri_closest_hit_tables(*args, **tb.kw, stats=True)
        ent, imp = int(entered.sum()), int(improved.sum())
        ops = tile_ops(ent, block)
        row = {"bounce": b.index, "active": b.active, "entered_tiles": ent,
               "improved_tiles": imp, "tiles_per_live_lane": ent / max(b.active, 1),
               "useful_pct": 100.0 * imp / max(ent, 1),
               "skip_pct": 100.0 * (1.0 - ent / max(b.active * n_clusters, 1)),
               "ops": ops, "ms": None, "achieved_ops_per_s": None, "peak_pct": None,
               "datasheet_pct": None, "bound_ms": None, "bound_by": None}
        if on_card:
            ms = cuda_ms(lambda: tri_closest_hit_tables(*args, **tb.kw), reps)
            rate = ops / (ms * 1e-3)
            bms, by = bound(b.o.shape[0], b.active, 8, table_bytes(*args[3:]), ent, block,
                            TRI_TEST_OPS)
            row.update(ms=ms, achieved_ops_per_s=rate, peak_pct=100.0 * rate / peak["ops_per_s"],
                       datasheet_pct=100.0 * rate / F32_OPS_PER_S, bound_ms=bms, bound_by=by)
            tot_ops += ops
            tot_ms += ms
        rows.append(row)
    return {
        "scene": str(scene_name), "device": str(wl.device), "rays": n,
        "depth": depth, "block_t": block, "clusters": n_clusters,
        "supers": bool(host.use_supers), "slabs": host.n_slabs,
        "tri_test_ops": TRI_TEST_OPS, "box_test_ops": BOX_TEST_OPS,
        "peak": peak, "total_ms": tot_ms if on_card else None,
        "achieved_ops_per_s": tot_ops / (tot_ms * 1e-3) if on_card and tot_ms else None,
        "peak_pct": (100.0 * tot_ops / (tot_ms * 1e-3) / peak["ops_per_s"]
                     if on_card and tot_ms else None),
        "bounces": rows,
    }


def report(s: dict) -> str:
    lines = [f"== {s['scene']} on {s['device']}: {s['rays']} rays, depth {s['depth']}, "
             f"{s['clusters']} clusters of {s['block_t']}, supers {s['supers']}, "
             f"{s['slabs']} slab(s)"]
    for r in s["bounces"]:
        line = (f"  bounce {r['bounce']}: active {r['active']:>8}, entered {r['entered_tiles']:>9} "
                f"({r['tiles_per_live_lane']:.3f}/live lane), useful {r['useful_pct']:5.1f}%, "
                f"skip {r['skip_pct']:5.1f}%")
        if r["ms"] is None:
            line += ", time not measured (no card)"
        else:
            line += (f", K1 {r['ms']:.4f} ms, {r['achieved_ops_per_s'] / 1e12:.3f} Tops/s = "
                     f"{r['peak_pct']:.2f}% of the derived peak ({r['datasheet_pct']:.2f}% of "
                     f"the data sheet's), bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        lines.append(line)
    if s["total_ms"] is not None:
        lines.append(f"  overall: {s['total_ms']:.3f} ms over {len(s['bounces'])} bounces, "
                     f"{s['achieved_ops_per_s'] / 1e12:.3f} Tops/s = {s['peak_pct']:.2f}% of "
                     f"the derived peak")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenes", nargs="*", default=["cornell_tex.pbrt", "mesh10k.pbrt"])
    ap.add_argument("--rays", type=int, default=1 << 22, help="rays per bounce (the render "
                    "path's chunk on the card)")
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    peak = card_peak() if args.device == "cuda" else None
    if peak:
        print(f"card: {peak['card']}; peak: {peak['derivation']}")
    out = {"peak": peak, "scenes": {}}
    for name in args.scenes:
        s = analyze(name, args.rays, args.depth, args.device, peak=peak)
        out["scenes"][name] = s
        print(report(s), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
