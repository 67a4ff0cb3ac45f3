"""What each element of the group kernel K4 (csrc/intersect_group.cu) is
worth on the card: the kernel with one element taken out or replaced at a
time, each variant built from the shipped source by text substitution,
timed in turns against the shipped kernel on every bounce of the shared
workload (tools/workload.py), and held to the shipped kernel's results (t
to the bit, rows, any-hit).

    python -m curry_pbrt_tpu_torch.tools.probe_group_walk [--scene mesh10k.pbrt]
        [--rays 4194304] [--depth 6] [--reps 5]

The variants, each one change from the shipped kernel:
  group rule     every live ray of the group tests every cluster the group
                 visits (no per-ray gate; the results are the same);
  butterfly      the tile's (t, row) reduced by a butterfly of 5 levels x 2
                 shuffles for each gated ray, not two __reduce_min_sync;
  scalar rows    each held row's 10 columns read as 10 scalar loads, not
                 two 16-byte and one 8-byte load;
  run-time axis  the triangle test's permutation by the ray's dominant
                 axis at run time (tri_test<-1, false>: selects,
                 NaN-checking maxima), not at compile time;
  every chunk    (any hit only) the chunk loop not stopped once every gated
                 ray has hit (90 registers and no spill, against 80 and a
                 12-byte spill);
  6 blocks an SM __launch_bounds__ asking for 6 blocks of 128 threads an SM
                 (at most 85 registers a thread);
  pair lanes     (closest hit only) lanes over (ray, row) pairs, each lane's
                 ray in registers: the gated rays' count m rounded up to a
                 power of two m2, lane l on gated ray l % m2 and rows
                 l / m2, + 32 / m2, ...; rows re-read by every lane that
                 needs them, the run-time axis (the lanes' rays differ), a
                 butterfly over the lanes of a ray;
  baseline       the *_group_rule kernels: the first port (PR 3), the group rule
                 with rows re-read for every ray and a butterfly for all 8.
Each call's times are the card's time alone (roofline.device_ms, in turns
with the shipped kernel).

Then, on each scene of --k1-scenes, the kernel at K1's granularity: K4
with 64-row chunks (2 rows a lane) over group tables of 64-row clusters,
against the warp K1 / K2 on the render path's 64-row tables, in turns on
every bounce, its t held bit-equal to K1's and its any-hit equal to K2's:
whether an 8-ray walk that shares the rows comes near the per-ray walk
when both test clusters of the same size.

Needs a card; the variants are built with nvcc into build/probe_group/.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
from pathlib import Path

import torch

from curry_pbrt_tpu_torch.ops.kernels import build
from curry_pbrt_tpu_torch.ops.kernels import intersect_group as G
from curry_pbrt_tpu_torch.ops.kernels import intersect_kernel as K
from curry_pbrt_tpu_torch.tools.probe_group_kernel import Pair
from curry_pbrt_tpu_torch.tools.roofline import device_ms, nvidia_smi, turns
from curry_pbrt_tpu_torch.tools.workload import Workload, load_scene

SOURCE = build.CSRC / "intersect_group.cu"
OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "probe_group"
ENTRIES = ("curry_tri_closest_hit_groups", "curry_tri_any_hit_groups")

_CLOSEST_TILE = """        float tile_t = FLT_MAX;  // on lane q: ray q's tile minimum
        int tile_row = 0;
        for (int base = 0; base < tb.block; base += CHUNK_ROWS) {
            float p[HELD][TRI_USED];
            load_held(rows, base, tb.block, lane, p);
            for (unsigned todo = gate; todo; todo &= todo - 1u) {
                const int q = __ffs(todo) - 1;
                const float frozen = __shfl_sync(FULL, t_best, q);  // at the cluster's start
                float bt = FLT_MAX;
                int br = 0;
                const Ray rq = rays[q];  // one broadcast read a cluster
                test_held_kz(p, base, lane, rq, frozen, k, bt, br);
                warp_min(bt, br);
                if (lane == q && bt < tile_t) {  // chunks ascend: an earlier row wins a tie
                    tile_t = bt;
                    tile_row = br;
                }
            }
        }
"""
_PAIR_TILE = """        const int m = __popc(gate);
        const int m2 = m <= 1 ? 1 : (m <= 2 ? 2 : (m <= 4 ? 4 : 8));
        const int slot = lane % m2;
        unsigned rest = gate;
        for (int s = 0; s < slot && rest; ++s) rest &= rest - 1u;
        const int q = rest ? __ffs(rest) - 1 : -1;  // the slot's gated ray
        const Ray rq = rays[q < 0 ? 0 : q];
        const float frozen = __shfl_sync(FULL, t_best, q < 0 ? 0 : q);
        float bt = FLT_MAX;
        int br = 0;
        if (q >= 0) {
            for (int i = lane / m2; i < tb.block; i += WARP / m2) {
                float p[TRI_USED];
                TriPrim::load(rows + (size_t)i * PRIM_COLS, p);
                const float t = tri_test<-1, true>(p, rq, frozen, k);
                if (t < bt) {
                    bt = t;
                    br = i;
                }
            }
        }
        for (int off = WARP / 2; off >= m2; off >>= 1) {
            const float ot = __shfl_xor_sync(FULL, bt, off);
            const int orow = __shfl_xor_sync(FULL, br, off);
            if (ot < bt || (ot == bt && orow < br)) {
                bt = ot;
                br = orow;
            }
        }
        const int rank = __popc(gate & ((1u << (lane % WARP)) - 1u));
        const float tile_t = __shfl_sync(FULL, bt, rank % WARP);
        const int tile_row = __shfl_sync(FULL, br, rank % WARP);
"""
_WARP_MIN = """    const unsigned key = __float_as_uint(bt);
    const unsigned k_min = __reduce_min_sync(FULL, key);
    br = static_cast<int>(__reduce_min_sync(FULL, key == k_min ? static_cast<unsigned>(br) : ~0u));
    bt = __uint_as_float(k_min);
"""
_BUTTERFLY = """#pragma unroll
    for (int off = WARP / 2; off > 0; off >>= 1) {
        const float ot = __shfl_xor_sync(FULL, bt, off);
        const int orow = __shfl_xor_sync(FULL, br, off);
        if (ot < bt || (ot == bt && orow < br)) {
            bt = ot;
            br = orow;
        }
    }
"""
_BY_AXIS = """    if (r.kz == 0)
        test_held<0>(p, base, lane, r, bound, k, bt, br);
    else if (r.kz == 1)
        test_held<1>(p, base, lane, r, bound, k, bt, br);
    else
        test_held<2>(p, base, lane, r, bound, k, bt, br);
"""
_BOUNDS = "__global__ void __launch_bounds__(WARPS_PER_BLOCK * WARP)\n    {}_group_kernel"
_BOUNDS_6 = "__global__ void __launch_bounds__(WARPS_PER_BLOCK * WARP, 6)\n    {}_group_kernel"
# (old, new, occurrences) applied to the shipped source, in order
VARIANTS = {
    "group rule": [("gate = __ballot_sync(FULL, (tn <= b * GATE_SLACK || isinf(b)) && b > 0.0f);",
                    "gate = __ballot_sync(FULL, lane < GROUP && b > 0.0f);", 1)],
    "butterfly": [(_WARP_MIN, _BUTTERFLY, 1)],
    "scalar rows": [("            TriPrim::load(rows + (size_t)i * PRIM_COLS, p[j]);",
                     "            for (int m = 0; m < TRI_USED; ++m) p[j][m] = rows[(size_t)i * "
                     "PRIM_COLS + m];", 1)],
    "run-time axis": [(_BY_AXIS, "    test_held<-1>(p, base, lane, r, bound, k, bt, br);\n", 1),
                      ("tri_test<KZ, true>(p[j]", "tri_test<KZ, false>(p[j]", 1)],
    "every chunk": [("for (int base = 0; base < tb.block && gate; base += CHUNK_ROWS)",
                     "for (int base = 0; base < tb.block; base += CHUNK_ROWS)", 1)],
    "6 blocks an SM": [(_BOUNDS.format("closest"), _BOUNDS_6.format("closest"), 1),
                       (_BOUNDS.format("any"), _BOUNDS_6.format("any"), 1)],
    "pair lanes": [(_CLOSEST_TILE, _PAIR_TILE, 1)],
}
CLOSEST_ONLY, ANY_ONLY = ("pair lanes",), ("every chunk",)
NAMES = ["shipped", *VARIANTS, "baseline"]


def variant_source(name: str) -> str:
    """The shipped source with variant `name`'s substitutions; raises where
    one does not match the source exactly as often as it should."""
    src = SOURCE.read_text()
    for old, new, count in VARIANTS[name]:
        if src.count(old) != count:
            raise ValueError(f"variant {name!r}: {old!r} occurs {src.count(old)} times, "
                             f"not {count}")
        src = src.replace(old, new)
    return src


def build_variants(sources=None) -> dict:
    """Compile every variant (one nvcc each, all started together) → {name:
    ctypes library with the two entry points declared}; -Xptxas -v's
    register report of each is kept beside it. sources: {name: source},
    by default every variant of VARIANTS."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    sources = sources or {name: variant_source(name) for name in VARIANTS}
    jobs = {}
    for name, src in sources.items():
        tag = hashlib.sha256((src + " ".join(build.NVCC_FLAGS)).encode()).hexdigest()[:12]
        cu, lib = OUT_DIR / f"group_{tag}.cu", OUT_DIR / f"libgroup_{tag}.so"
        cu.write_text(src)
        proc = None if lib.exists() else subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I",
             str(build.CSRC), "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (lib, proc)
    libs = {}
    for name, (lib, proc) in jobs.items():
        if proc is not None:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
            lib.with_suffix(".ptxas.txt").write_text(log)
        libs[name] = ctypes.CDLL(str(lib))
        for entry in ENTRIES:
            fn = getattr(libs[name], entry)
            fn.argtypes, fn.restype = build.ENTRY_POINTS[entry], ctypes.c_int
    return libs


def _launcher(tab, kw, o, d):
    """run(lib, kind, t_max) → the outputs of one K4 launch from `lib` on
    DeviceTables `tab`."""
    def run(lib, kind, t_max):
        outs = ([torch.empty(o.shape[:1], dtype=torch.float32, device=o.device),
                 torch.empty(o.shape[:1], dtype=torch.int32, device=o.device)]
                if kind == "closest" else
                [torch.empty(o.shape[:1], dtype=torch.bool, device=o.device)])
        K.launch_entry(lib, ENTRIES[0] if kind == "closest" else ENTRIES[1], outs, o, d, t_max,
                       tab.tris16, tab.caabb, tab.saabb, tab.slab_aabb, kw["block_t"],
                       kw["clusters_per_slab"], True)
        return outs
    return run


def at_k1_rows(scene_name, n_rays: int = 1 << 22, depth: int = 6, reps: int = 5,
               device="cuda", seed: int = 0) -> dict:
    """K4 with 64-row chunks over 64-row group tables against the warp K1 /
    K2 on the render path's tables, in turns (device ms), on every bounce;
    raises where its t is not K1's or its any-hit not K2's."""
    src = SOURCE.read_text()
    chunk = "constexpr int CHUNK_ROWS = 128;"
    if src.count(chunk) != 1:
        raise ValueError(f"{chunk!r} does not occur once in {SOURCE.name}")
    lib = build_variants({"64-row chunks": src.replace(chunk, "constexpr int CHUNK_ROWS = 64;")})[
        "64-row chunks"]
    wl = Workload(load_scene(scene_name), device)
    k1 = wl.tables
    sc = wl.scene
    host = G.group_tables(sc.tris.p0, sc.tris.p1, sc.tris.p2, sc.tris.prim,
                          view_origin=wl.view, block_t=k1.kw["block_t"])
    tab = K.DeviceTables(host, device)
    kw = G.group_kw(tab)
    rows = []
    for b in wl.bounces(n_rays, depth, seed):
        tm_s = torch.where(b.t < 1e29, b.t * 0.999, b.t_max)
        run = _launcher(tab, kw, b.o, b.d)
        t4, _ = run(lib, "closest", b.t_max)
        h4, = run(lib, "any", tm_s)
        if not (torch.equal(t4, b.t) and torch.equal(h4, k1.any_hit(b.o, b.d, tm_s))):
            raise AssertionError(f"{scene_name} bounce {b.index}: K4 at K1's rows differs from "
                                 f"K1 / K2")
        k1_ms, k4_ms = turns(lambda: k1.closest(b.o, b.d, b.t_max),
                             lambda: run(lib, "closest", b.t_max), reps, device_ms)
        k2_ms, k4a_ms = turns(lambda: k1.any_hit(b.o, b.d, tm_s), lambda: run(lib, "any", tm_s),
                              reps, device_ms)
        rows.append({"bounce": b.index, "live": b.active, "k4_ms": k4_ms, "k1_ms": k1_ms,
                     "k4_any_ms": k4a_ms, "k2_ms": k2_ms})
    return {"card": nvidia_smi("name,power.limit"), "scene": str(scene_name), "rays": n_rays,
            "reps": reps, "k4_clusters": int(host.cluster_aabbs.shape[0]),
            "k4_slabs": host.n_slabs, "k1_clusters": int(k1.caabb.shape[0]),
            "block_t": k1.kw["block_t"], "rows": rows}


def report_k1_rows(s: dict) -> str:
    lines = [f"K4 at K1's granularity ({s['card']}; {s['scene']}, {s['rays']} rays; K4 over "
             f"{s['k4_clusters']} clusters of {s['block_t']} in {s['k4_slabs']} slab(s), K1 / K2 "
             f"over the render path's {s['k1_clusters']}; device ms in turns, {s['reps']} reps; "
             f"t bit-equal to K1's, any-hit equal to K2's)"]
    for r in s["rows"]:
        lines.append(f"  bounce {r['bounce']}: live {r['live']:>8}; closest K4 {r['k4_ms']:.4f} "
                     f"ms, K1 {r['k1_ms']:.4f} ({r['k4_ms'] / r['k1_ms']:.2f}x); any K4 "
                     f"{r['k4_any_ms']:.4f} ms, K2 {r['k2_ms']:.4f} "
                     f"({r['k4_any_ms'] / r['k2_ms']:.2f}x)")
    tot = {k: sum(r[k] for r in s["rows"]) for k in ("k4_ms", "k1_ms", "k4_any_ms", "k2_ms")}
    lines.append(f"  over the bounces: closest K4 {tot['k4_ms']:.3f} ms, K1 {tot['k1_ms']:.3f}; "
                 f"any K4 {tot['k4_any_ms']:.3f} ms, K2 {tot['k2_ms']:.3f}")
    return "\n".join(lines)


def analyze(scene_name="mesh10k.pbrt", n_rays: int = 1 << 22, depth: int = 6, reps: int = 5,
            device="cuda", seed: int = 0) -> dict:
    """Every variant and the baseline against the shipped kernel, in turns,
    on each bounce's closest-hit rays and its shadow rays (t_max 0.999 of
    the closest t) → a summary dict of device ms."""
    if torch.device(device).type != "cuda":
        raise ValueError("the probe times kernels on the card: device must be cuda")
    libs = build_variants()
    shipped = build.load_library()
    wl = Workload(load_scene(scene_name), device)
    p = Pair(wl)
    tab = p.k4
    rows = []
    for b in wl.bounces(n_rays, depth, seed):
        tm_s = torch.where(b.t < 1e29, b.t * 0.999, b.t_max)
        run_on = _launcher(tab, p.kw4, b.o, b.d)
        for kind, tm in (("closest", b.t_max), ("any", tm_s)):
            def run(lib, kind=kind, tm=tm):
                return run_on(lib, kind, tm)

            base = ((lambda: p.closest4_rule(b.o, b.d, tm)) if kind == "closest"
                    else (lambda: [p.any4_rule(b.o, b.d, tm)]))
            ref = run(shipped)
            row = {"bounce": b.index, "kind": kind, "live": int((tm > 0).sum()), "ms": {}}
            ship_ms = []
            for name in [*VARIANTS, "baseline"]:
                if name in (CLOSEST_ONLY if kind == "any" else ANY_ONLY):
                    continue
                fn = base if name == "baseline" else (lambda lib=libs[name]: run(lib))
                got = fn()
                same = all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                                       y.view(torch.int32) if y.dtype == torch.float32 else y)
                           for x, y in zip(got, ref))
                if not same:
                    raise AssertionError(f"{kind} bounce {b.index}: variant {name!r} differs "
                                         f"from the shipped kernel")
                s_ms, row["ms"][name] = turns(lambda: run(shipped), fn, reps, device_ms)
                ship_ms.append(s_ms)
            row["ms"]["shipped"] = sum(ship_ms) / len(ship_ms)
            rows.append(row)
    totals = {kind: {v: sum(r["ms"][v] for r in rows if r["kind"] == kind and v in r["ms"])
                     for v in NAMES} for kind in ("closest", "any")}
    return {"card": nvidia_smi("name,power.limit"), "scene": str(scene_name), "rays": n_rays,
            "depth": depth, "reps": reps, "rows": rows, "totals": totals}


def report(s: dict) -> str:
    lines = [f"group kernel K4, element by element ({s['card']}; {s['scene']}, {s['rays']} "
             f"rays, depth {s['depth']}: device ms, each variant in turns with the shipped "
             f"kernel, {s['reps']} reps)",
             "  bounce kind        live " + "".join(f"{v:>14}" for v in NAMES)]
    for r in s["rows"]:
        lines.append(f"  {r['bounce']:>6} {r['kind']:>7} {r['live']:>9} "
                     + "".join(f"{r['ms'][v]:>14.4f}" if v in r["ms"] else f"{'-':>14}"
                               for v in NAMES))
    for kind, sums in s["totals"].items():
        lines.append(f"  {kind} over the bounces: "
                     + ", ".join(f"{v} {sums[v]:.4f}" for v in NAMES if sums[v]))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="mesh10k.pbrt")
    ap.add_argument("--k1-scenes", nargs="*", default=["mesh10k.pbrt", "mesh100k.pbrt"])
    ap.add_argument("--rays", type=int, default=1 << 22)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args(argv)
    print(report(analyze(a.scene, a.rays, a.depth, a.reps)), flush=True)
    for scene in a.k1_scenes:
        print(report_k1_rows(at_k1_rows(scene, a.rays, a.depth, a.reps)), flush=True)


if __name__ == "__main__":
    main()
