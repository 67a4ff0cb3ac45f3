#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (curry_pbrt_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises, so the exit code is
non-zero and no result line is printed:
  1. device  — requires CUDA; prints the card's name and power limit
               (nvidia-smi) and the torch / nvcc versions;
  2. build   — compiles csrc/*.cu with nvcc (sm_90a, -fmad=false) and prints
               the build time and ptxas' register report;
  3. kernels — the closest-hit (K1) and any-hit (K2) kernels against their
               plain PyTorch versions on the card: cornell_tex tables
               (block_t 8, one slab) and a 5k-triangle soup (block_t 64,
               supers, 5 slabs, a NaN padding cluster), 32k and 1M rays with
               dead lanes, plus the render path's chunk shape. Hit masks and
               rows must be equal (rows up to exact-t ties) and t bit-equal —
               the build's -fmad=false is what makes that hold;
  4. slice   — cornell_tex at 32², 4 spp, depth 3 through render_scene on
               the card, against tests/goldens/cornell_tex.npy under the CPU
               slice test's tolerance, and against the port's own CPU
               render (plain versions); both kernels must have launched and
               the plain versions must not have run on the card;
  5. headline— cornell_tex at 512², 64 spp, depth 5: a warm-up pass, then a
               timed pass whose launch counts are reported; traced segments
               and the image sum against the JAX anchors (155,670,944 within
               1e-4 relative; 86446.0 within 1e-3 relative);
and then prints the per-kernel JSON line and, last, the device line.

Imports nothing of JAX. Run from the repository root's checkout.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# JAX anchors for the headline (hardware-independent: traced segments and
# image checksum of the JAX package's bench run, BENCH_r05.json)
HEADLINE = dict(res=512, spp=64, depth=5)
ANCHOR_SEGMENTS = 155_670_944
ANCHOR_CHECKSUM = 86446.0
SEG_RTOL, SUM_RTOL = 1e-4, 1e-3
# slice tolerance: the CPU slice test's (tests/test_torch_render.py)
SLICE_RTOL = SLICE_ATOL = 1e-4
SLICE_MAX_OUTLIER_FRAC = 0.01
SLICE_SUM_RTOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def soup_tables(n_tris: int, seed: int):
    import numpy as np

    from curry_pbrt_tpu_torch.ops.kernels.intersect_kernel import build_tri_tables

    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-8, 8, (n_tris, 3)).astype(np.float32)
    p1 = p0 + rng.normal(0, 0.6, (n_tris, 3)).astype(np.float32)
    p2 = p0 + rng.normal(0, 0.6, (n_tris, 3)).astype(np.float32)
    return build_tri_tables(p0, p1, p2, np.arange(n_tris, dtype=np.int32), block_t=64,
                            view_origin=np.zeros(3), clusters_per_slab=16, use_supers=True)


def make_rays(n: int, seed: int, center, spread: float, device):
    """Rays from a box around `center` in random directions; every 7th lane
    is dead (t_max 0), the others unbounded (FLOAT_MAX) or bounded."""
    import numpy as np
    import torch

    from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX

    rng = np.random.default_rng(seed)
    o = (np.asarray(center, np.float32) + rng.uniform(-spread, spread, (n, 3))).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(rng.uniform(size=n) < 0.5, FLOAT_MAX, spread).astype(np.float32)
    t_max[::7] = 0.0
    return tuple(torch.from_numpy(a).to(device) for a in (o, d, t_max))


def row_t(tables, o, d, t_max, rows):
    """t of each ray against one given table row (-1 → FLOAT_MAX)."""
    import torch

    from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX
    from curry_pbrt_tpu_torch.ops.intersect import ray_shear, watertight_core

    tri = tables.tris16[rows.clamp(min=0).long()]
    kz, sx, sy, sz = ray_shear(d)
    t, _, ok = watertight_core(o, kz, sx, sy, sz, t_max, tri[:, 0:3], tri[:, 3:6], tri[:, 6:9],
                               with_bary=False)
    return torch.where(ok & (tri[:, 9] > 0) & (rows >= 0), t, float(FLOAT_MAX))


def check_kernels(name, tables, rays, K, plain, timing: bool):
    """Kernel vs plain on one table set and ray batch; returns timings."""
    import torch

    o, d, t_max = rays
    n = o.shape[0]
    kw = tables.kw
    args = (o, d, t_max, tables.tris16, tables.caabb, tables.saabb, tables.slab_aabb)
    t_k, r_k = K.tri_closest_hit_tables(*args, **kw)
    h_k = K.tri_any_hit_tables(*args, **kw)
    torch.cuda.synchronize()
    t_p, r_p = plain["closest"](*args, **kw)
    h_p = plain["any"](*args, **kw)
    hit_k, hit_p = r_k >= 0, r_p >= 0
    if not torch.equal(hit_k, hit_p):
        raise AssertionError(f"{name}: K1 hit masks differ on {(hit_k != hit_p).sum().item()} rays")
    if not torch.equal(h_k, h_p):
        raise AssertionError(f"{name}: K2 results differ on {(h_k != h_p).sum().item()} rays")
    if not torch.equal(t_k, t_p):
        bad = (t_k != t_p)
        rel = ((t_k - t_p).abs() / t_p.abs().clamp(min=1e-30))[bad].max().item()
        raise AssertionError(f"{name}: K1 t not bit-equal on {bad.sum().item()} rays "
                             f"(max rel {rel:.3g})")
    diff = r_k != r_p
    if diff.any():  # allowed only where both rows give the same t (a tie)
        tk = row_t(tables, o[diff], d[diff], t_max[diff], r_k[diff])
        tp = row_t(tables, o[diff], d[diff], t_max[diff], r_p[diff])
        if not (torch.equal(tk, tp) and torch.equal(tk, t_k[diff])):
            raise AssertionError(f"{name}: K1 rows differ beyond exact-t ties")
    dead = t_max == 0
    if hit_k[dead].any() or h_k[dead].any():
        raise AssertionError(f"{name}: a dead lane (t_max 0) reported a hit")
    max_abs = (t_k[hit_k] - t_p[hit_k]).abs().max().item() if hit_k.any() else 0.0
    log(f"  {name}: {n} rays, {int(hit_k.sum())} closest hits, {int(h_k.sum())} any hits, "
        f"{int(diff.sum())} tie rows — masks equal, t bit-equal, rows equal up to ties")
    out = {"max_abs_err": max_abs,
           "any_max_abs_err": (h_k.float() - h_p.float()).abs().max().item() if n else 0.0}
    if timing:
        out["closest_ms"] = cuda_ms(lambda: K.tri_closest_hit_tables(*args, **kw), 20)
        out["any_ms"] = cuda_ms(lambda: K.tri_any_hit_tables(*args, **kw), 20)
        out["closest_plain_ms"] = cuda_ms(lambda: plain["closest"](*args, **kw), 3)
        out["any_plain_ms"] = cuda_ms(lambda: plain["any"](*args, **kw), 3)
        log(f"    K1 {out['closest_ms']:.3f} ms (plain {out['closest_plain_ms']:.3f} ms), "
            f"K2 {out['any_ms']:.3f} ms (plain {out['any_plain_ms']:.3f} ms)")
    return out


def main() -> int:
    if not (REPO / "curry_pbrt_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: the curry_pbrt_tpu_torch package is not beside this script")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — this needs a GPU")
    sys.path.insert(0, str(REPO))

    # ---- 1. device
    card = card_line()
    log(card)  # the card's name and power limit, as nvidia-smi gives them
    from curry_pbrt_tpu_torch.ops.kernels import build

    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    log(f"[device] torch {torch.__version__} (CUDA {torch.version.cuda}), nvcc: {nvcc}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    # ---- 2. build
    t0 = time.time()
    build.build(verbose=True)
    build.load_library()
    log(f"[build] nvcc {' '.join(build.NVCC_FLAGS)}: {time.time() - t0:.1f} s")

    # ---- 3. kernels against their plain versions
    from curry_pbrt_tpu_torch.ops.kernels import intersect_kernel as K
    from curry_pbrt_tpu_torch.ops.kernels.aggregate import plan_tri_kernel
    from curry_pbrt_tpu_torch.render import CHUNK_RAYS
    from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file

    plain = {"closest": K.tri_closest_hit_plain, "any": K.tri_any_hit_plain}
    scene = compile_scene_file(REPO / "scenes" / "cornell_tex.pbrt")
    cam = np.asarray(scene.camera.camera_to_world)[:3, 3]
    ctab_host = plan_tri_kernel(scene.tris, cam)
    ctab = K.DeviceTables(ctab_host, dev)
    stab_host = soup_tables(5000, seed=1)
    stab = K.DeviceTables(stab_host, dev)
    log(f"[kernels] cornell_tex tables: {ctab_host.cluster_aabbs.shape[0]} clusters of "
        f"{ctab_host.block_t}, {ctab_host.n_slabs} slab; soup: "
        f"{stab_host.cluster_aabbs.shape[0]} clusters of {stab_host.block_t}, "
        f"{stab_host.n_slabs} slabs, supers {stab_host.use_supers}, "
        f"{int(np.isnan(stab_host.cluster_aabbs[:, 0]).sum())} NaN padding clusters")
    box_c = (278.0, 274.0, 280.0)
    chunk = CHUNK_RAYS["cuda"]
    timings = {}
    for n in (1 << 15, 1 << 20, chunk):
        timings[("cornell", n)] = check_kernels(
            f"cornell_tex/{n}", ctab, make_rays(n, 10 + n % 97, box_c, 280.0, dev), K, plain,
            timing=True)
        if n < chunk:
            timings[("soup", n)] = check_kernels(
                f"soup5k/{n}", stab, make_rays(n, 20 + n % 89, (0, 0, 0), 9.0, dev), K, plain,
                timing=True)

    # ---- 4. the slice at test size, on the card
    from curry_pbrt_tpu_torch.render import render_scene

    calls = {"plain": 0}

    def forbid(fn):
        def wrapped(o, *a, **kw):
            if o.device.type == "cuda":
                calls["plain"] += 1
            return fn(o, *a, **kw)
        return wrapped

    K.tri_closest_hit_plain = forbid(plain["closest"])
    K.tri_any_hit_plain = forbid(plain["any"])
    small = compile_scene_file(REPO / "scenes" / "cornell_tex.pbrt",
                               overrides={"resolution": (32, 32), "spp": 4, "max_depth": 3})
    K.reset_launches()
    img, seg_small = render_scene(small, device="cuda", show_progress=False, count_rays=True)
    launches_small = dict(K.LAUNCHES)
    gold = np.load(REPO / "tests" / "goldens" / "cornell_tex.npy")
    close = np.isclose(img, gold, rtol=SLICE_RTOL, atol=SLICE_ATOL)
    frac = 1.0 - close.mean()
    sum_rel = abs(float(img.sum()) - float(gold.sum())) / float(gold.sum())
    log(f"[slice] 32² 4 spp depth 3: max |Δ| {np.abs(img - gold).max():.3g}, "
        f"{frac:.4%} of values outside rtol=atol={SLICE_RTOL}, image sum rel {sum_rel:.3g}, "
        f"{seg_small} segments, launches {launches_small}, plain calls on CUDA {calls['plain']}")
    if img.shape != gold.shape or not np.isfinite(img).all():
        raise AssertionError("slice image has the wrong shape or non-finite values")
    if frac > SLICE_MAX_OUTLIER_FRAC or sum_rel > SLICE_SUM_RTOL:
        raise AssertionError("slice render disagrees with tests/goldens/cornell_tex.npy")
    if min(launches_small.values()) <= 0 or calls["plain"]:
        raise AssertionError("the slice did not run through both kernels alone")
    img_cpu = render_scene(small, device="cpu", show_progress=False)
    cpu_close = np.isclose(img, img_cpu, rtol=SLICE_RTOL, atol=SLICE_ATOL)
    log(f"[slice] card vs the port on the CPU (plain versions): max |Δ| "
        f"{np.abs(img - img_cpu).max():.3g}, {int((img != img_cpu).sum())} of {img.size} values "
        f"differ, {1.0 - cpu_close.mean():.4%} outside rtol=atol={SLICE_RTOL}")
    if 1.0 - cpu_close.mean() > SLICE_MAX_OUTLIER_FRAC:
        raise AssertionError("the card's slice render disagrees with the port's CPU render")

    # ---- 5. headline
    res, spp, depth = HEADLINE["res"], HEADLINE["spp"], HEADLINE["depth"]
    head = compile_scene_file(REPO / "scenes" / "cornell_tex.pbrt",
                              overrides={"resolution": (res, res), "spp": spp, "max_depth": depth})
    warm = compile_scene_file(REPO / "scenes" / "cornell_tex.pbrt",
                              overrides={"resolution": (128, 128), "spp": spp, "max_depth": depth})
    render_scene(warm, device="cuda", show_progress=False)
    torch.cuda.synchronize()
    K.reset_launches()  # counts of the main path's run start here
    t0 = time.time()
    img, segments = render_scene(head, device="cuda", show_progress=False, count_rays=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(K.LAUNCHES)
    checksum = float(img.astype(np.float64).sum())
    seg_rel = abs(segments - ANCHOR_SEGMENTS) / ANCHOR_SEGMENTS
    sum_rel = abs(checksum - ANCHOR_CHECKSUM) / ANCHOR_CHECKSUM
    log(f"[headline] cornell_tex {res}² {spp} spp depth {depth} on {card}: wall {wall:.3f} s, "
        f"{segments} segments ({segments / wall:.4g} seg/s), checksum {checksum:.2f}; "
        f"vs JAX anchors: segments rel {seg_rel:.3g} (≤ {SEG_RTOL}), checksum rel "
        f"{sum_rel:.3g} (≤ {SUM_RTOL}); launches {launches}, plain calls on CUDA {calls['plain']}")
    if img.shape != (res, res, 3) or not np.isfinite(img).all():
        raise AssertionError("headline image has the wrong shape or non-finite values")
    if seg_rel > SEG_RTOL or sum_rel > SUM_RTOL:
        raise AssertionError("headline disagrees with the JAX anchors")
    if min(launches.values()) <= 0 or calls["plain"]:
        raise AssertionError("the headline did not run through both kernels alone")

    # ---- report
    main_shape = timings[("cornell", chunk)]
    src = "curry_pbrt_tpu_torch/csrc/intersect.cu"
    kernels = [
        {"name": "tri_closest_hit", "route": "cuda", "source": src,
         "replaces": "curry_pbrt_tpu/ops/pallas/intersect_kernel.py:709",
         "launches": launches["tri_closest"], "max_abs_err": main_shape["max_abs_err"],
         "ms": main_shape["closest_ms"], "plain_ms": main_shape["closest_plain_ms"]},
        {"name": "tri_any_hit", "route": "cuda", "source": src,
         "replaces": "curry_pbrt_tpu/ops/pallas/intersect_kernel.py:760",
         "launches": launches["tri_any"], "max_abs_err": main_shape["any_max_abs_err"],
         "ms": main_shape["any_ms"], "plain_ms": main_shape["any_plain_ms"]},
    ]
    for (tab, n), tm in sorted(timings.items()):
        log(f"[kernels] {tab}/{n} rays on {card}: K1 {tm['closest_ms']:.4f} ms (plain "
            f"{tm['closest_plain_ms']:.4f}), K2 {tm['any_ms']:.4f} ms (plain "
            f"{tm['any_plain_ms']:.4f})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
