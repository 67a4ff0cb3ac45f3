"""What each element of the small-table walk (csrc/intersect_small.cu, K1 and
K2 at block_t <= 8) is worth on the card: the walk with its elements taken
out one after another, each variant built from the shipped source by text
substitution, timed in turns against the shipped walk on every K1 / K2 call
of one chunk of the headline pass, and held to the shipped walk's results
(t to the bit, rows, any-hit).

    python -m curry_pbrt_tpu_torch.tools.probe_small_walk [--scene cornell_tex.pbrt]
        [--res 512] [--spp 64] [--depth 5] [--reps 10]

The variants: "1 bin", "run-time axis" and "global" each without one more
element than the one before, "mixed serial" and "1 ray a thread" beside
them:
  shipped        the walk the render path launches;
  mixed serial   a warp that holds rays of several axes walks each axis in
                 turn (compile-time axis throughout) instead of once with
                 the axis at run time;
  1 ray a thread each CTA takes 256 rays, not up to 1,024 (scan 1);
  1 bin          no partition by axis: the live rays walked in ray order
                 (compile-time axis where a warp's rays happen to share it);
  run-time axis  and the dominant axis a run-time value on every warp
                 (tri_test<-1, false>: selects, NaN-checking maxima); dead
                 rays still skipped;
  global         and the table read where it lies (L1 / L2) instead of
                 staged in shared memory.
Each call's times are the card's time alone (roofline.device_ms, in turns
with the shipped walk); the sums are per headline pass (x its chunks).
Needs a card; the variants are built with nvcc into build/probe_small/.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
from pathlib import Path

import numpy as np
import torch

from curry_pbrt_tpu_torch.ops.kernels import build
from curry_pbrt_tpu_torch.ops.kernels import intersect_kernel as K
from curry_pbrt_tpu_torch.tools.roofline import device_ms, nvidia_smi, turns

SOURCE = build.CSRC / "intersect_small.cu"
OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "probe_small"
_DISPATCH = "const int kz = __match_any_sync(active, r.kz) == active ? r.kz : -1;"
_ONE_BIN = [("return (ax >= ay && ax >= az) ? 0 : (ay >= az ? 1 : 2);", "return 0;", 1)]
_RUNTIME = _ONE_BIN + [(_DISPATCH, "const int kz = -1;", 1),
                       ("tri_test<KZ, true>", "tri_test<KZ, false>", 3)]
# (old, new, occurrences) applied to the shipped source, in order
VARIANTS = {
    "mixed serial": [(_DISPATCH, "const int kz = r.kz;", 1)],
    "1 ray a thread": [("constexpr int MAX_SCAN = 4;", "constexpr int MAX_SCAN = 1;", 1)],
    "1 bin": _ONE_BIN,
    "run-time axis": _RUNTIME,
    "global": _RUNTIME + [
        ("const float* rows = reinterpret_cast<const float*>(smem);",
         "const float* rows = prims;", 1),
        ("const float* boxes = rows + n_rows * ROW;", "const float* boxes = caabb;", 1),
        ("constexpr int ROW = 12;", "constexpr int ROW = PRIM_COLS;", 1),
        ("e < row_quads + n_clusters * BOX_QUADS;", "e < 0;", 1)],
}


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


def build_variants() -> dict:
    """Compile every variant (one nvcc each, all started together) → {name:
    ctypes library with the two entry points declared}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in VARIANTS:
        src = variant_source(name)
        tag = hashlib.sha256((src + " ".join(build.NVCC_FLAGS)).encode()).hexdigest()[:12]
        cu, lib = OUT_DIR / f"small_{tag}.cu", OUT_DIR / f"libsmall_{tag}.so"
        cu.write_text(src)
        proc = None if lib.exists() else subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-I", str(build.CSRC), "-o",
             str(lib), str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (lib, proc)
    libs = {}
    for name, (lib, proc) in jobs.items():
        if proc is not None:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
        for entry in ("curry_tri_closest_hit_small", "curry_tri_any_hit_small"):
            fn = getattr(libs[name], entry)
            fn.argtypes, fn.restype = build.ENTRY_POINTS[entry], ctypes.c_int
    return libs


def capture_headline_chunk(scene_path, res: int, spp: int, depth: int, device):
    """Render the scene once on the card and keep the K1 / K2 inputs of its
    first chunk (2·depth + 1 closest and depth any-hit calls: the render loop
    finishes a chunk before the next) → ({("closest" | "any", call): (o, d,
    t_max)}, DeviceTables, chunks a pass)."""
    from curry_pbrt_tpu_torch.ops.kernels.aggregate import plan_tri_kernel
    from curry_pbrt_tpu_torch.render import render_scene
    from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file

    scene = compile_scene_file(scene_path, overrides={
        "resolution": (res, res), "spp": spp, "max_depth": depth})
    want = {"closest": 2 * depth + 1, "any": depth}
    calls, captured = {"closest": 0, "any": 0}, {}
    originals = K.tri_closest_hit_tables, K.tri_any_hit_tables

    def capturing(fn, kind):
        def wrapped(o, d, t_max, *a, **kw):
            calls[kind] += 1
            if calls[kind] <= want[kind]:
                captured[(kind, calls[kind])] = (o.clone(), d.clone(), t_max.clone())
            return fn(o, d, t_max, *a, **kw)
        return wrapped

    K.tri_closest_hit_tables = capturing(originals[0], "closest")
    K.tri_any_hit_tables = capturing(originals[1], "any")
    try:
        render_scene(scene, device=device, show_progress=False)
    finally:
        K.tri_closest_hit_tables, K.tri_any_hit_tables = originals
    if len(captured) != sum(want.values()) or calls["closest"] % want["closest"]:
        raise RuntimeError(f"captured {sorted(captured)} of {calls} calls: not whole chunks of "
                           f"{want}")
    cam = np.asarray(scene.camera.camera_to_world)[:3, 3]
    tables = K.DeviceTables(plan_tri_kernel(scene.tris, cam), device)
    return captured, tables, calls["closest"] // want["closest"]


def analyze(scene_path, res=512, spp=64, depth=5, reps=10, device="cuda") -> dict:
    """Every variant against the shipped walk, in turns, on each captured
    call → a summary dict (per-call and per-pass device ms)."""
    if torch.device(device).type != "cuda":
        raise ValueError("the probe times kernels on the card: device must be cuda")
    libs = build_variants()
    captured, tab, n_chunks = capture_headline_chunk(scene_path, res, spp, depth, device)
    if tab.plan != "small":
        raise ValueError(f"the scene's tables take the {tab.plan} walk, not the small walk")
    shipped = build.load_library()
    rows = []
    for (kind, call), (o, d, t_max) in sorted(captured.items()):
        args = (o, d, t_max, tab.tris16, tab.caabb, tab.saabb, tab.slab_aabb,
                tab.kw["block_t"], tab.kw["clusters_per_slab"], tab.kw["use_supers"])
        entry = f"curry_tri_{kind}_hit_small"

        def run(lib):
            outs = K._closest_outputs(o, False) if kind == "closest" else [
                torch.empty(o.shape[:1], dtype=torch.bool, device=o.device)]
            K.launch_entry(lib, entry, outs + ([None, None] if kind == "closest" else []), *args)
            return outs

        ref = run(shipped)
        row = {"kind": kind, "call": call, "n": o.shape[0], "live": int((t_max > 0).sum()),
               "ms": {}}
        for name, lib in libs.items():
            got = run(lib)
            if kind == "closest":
                same = torch.equal(got[0].view(torch.int32), ref[0].view(torch.int32)) and \
                    torch.equal(got[1], ref[1])
            else:
                same = torch.equal(got[0], ref[0])
            if not same:
                raise AssertionError(f"{kind} call {call}: variant {name!r} differs from the "
                                     f"shipped walk")
            ship_ms, row["ms"][name] = turns(lambda: run(shipped), lambda lib=lib: run(lib),
                                             reps, device_ms)
            row["ms"].setdefault("shipped", []).append(ship_ms)
        row["ms"]["shipped"] = sum(row["ms"]["shipped"]) / len(row["ms"]["shipped"])
        rows.append(row)
    names = ["shipped", *VARIANTS]
    per_pass = {kind: {v: n_chunks * sum(r["ms"][v] for r in rows if r["kind"] == kind)
                       for v in names} for kind in ("closest", "any")}
    return {"card": nvidia_smi("name,power.limit"), "scene": str(scene_path), "res": res,
            "spp": spp, "depth": depth, "chunks": n_chunks, "reps": reps, "variants": names,
            "calls": rows, "per_pass": per_pass}


def report(s: dict) -> str:
    names = s["variants"]
    lines = [f"small-table walk, element by element ({s['card']}; {Path(s['scene']).name} "
             f"{s['res']}², {s['spp']} spp, depth {s['depth']}: one chunk's calls, device ms, "
             f"each variant in turns with the shipped walk, {s['reps']} reps)",
             "  call                 live     " + "".join(f"{v:>12}" for v in names)]
    for r in s["calls"]:
        lines.append(f"  {r['kind']:>7} {r['call']:>2} {r['n']:>9} {r['live']:>9} "
                     + "".join(f"{r['ms'][v]:>12.4f}" for v in names))
    for kind, sums in s["per_pass"].items():
        lines.append(f"  {kind} per pass (x {s['chunks']} chunks): "
                     + ", ".join(f"{v} {sums[v]:.4f}" for v in names))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="cornell_tex.pbrt")
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args(argv)
    scene = Path(a.scene)
    if not scene.exists():
        scene = Path(__file__).resolve().parents[2] / "scenes" / a.scene
    print(report(analyze(scene, a.res, a.spp, a.depth, a.reps)))


if __name__ == "__main__":
    main()
