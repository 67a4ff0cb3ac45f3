#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (curry_pbrt_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises, so the exit code is
non-zero and no result line is printed:
  1. device  — requires CUDA; prints the card's name and power limit
               (nvidia-smi) and the torch / nvcc versions;
  2. build   — compiles csrc/*.cu with nvcc (sm_90a, -fmad=false; one nvcc
               per source, all started together) and prints the build time
               and ptxas' register report;
  3. kernels — the closest-hit (K1) and any-hit (K2) kernels, through both
               walks — the warp walk (csrc/intersect_warp.cu) and the
               per-thread walk (csrc/intersect.cu) — against their plain
               PyTorch versions and each other on the card: cornell_tex
               tables (block_t 8, one slab) and a 5k-triangle soup (block_t
               64, supers, 5 slabs, a NaN padding cluster), 32k and 1M rays
               with dead lanes, the render path's chunk shape, a batch whose
               t_max is each ray's exact hit t (the first-hit-at-t_max rule)
               and one with ~90% dead lanes at the chunk shape. Hit masks
               must be equal, rows up to exact-t ties, t bit-equal — the
               build's -fmad=false is what makes that hold; both walks' ms
               in turns (the launch plan keeps the per-thread walk at
               block_t 8, and the line says whether it still measures
               faster there);
  3b. spheres— the sphere kernels (K3, closest and any hit) through both
               walks — the warp walk (csrc/intersect_warp.cu), which the
               launch plan picks for the 64-row sphere tables, and the
               per-thread walk (csrc/intersect.cu) — against their plain
               versions and each other: the spherefield10k tables and a
               soup of rotated, anisotropically scaled spheres (supers,
               several slabs, a NaN padding cluster), 32k and 1M rays with
               dead lanes plus the sphere field's chunk shape, a t_max-tie
               batch on each, ~90% dead lanes at the chunk shape, and rays
               that start on a sphere's surface (hits at t = -0.0); masks
               and any-hit equal, t bit-equal (sign bit included), spheres
               equal up to exact-t ties; both walks' ms in turns;
  3c. stats  — K1 with stats=True, both walks, against the plain version's
               stats on the triangle soup and the mesh100k tables: per-ray
               (entered, improved) counts equal, (t, row) unchanged by stats;
  4. slice   — cornell_tex at 32², 4 spp, depth 3 through render_scene on
               the card, against tests/goldens/cornell_tex.npy under the CPU
               slice test's tolerance, and against the port's own CPU
               render (plain versions); the K1 / K2 walk of the path's
               launch plan must have launched, the other walk and the plain
               versions not;
  5. headline— cornell_tex at 512², 64 spp, depth 5: a warm-up pass, then a
               timed pass whose launch counts are reported; traced segments
               and the image sum against the JAX anchors (155,670,944 within
               1e-4 relative; 86446.0 within 1e-3 relative), and the plan's
               walk alone, as in phase 4;
  6. configs — spherefield10k_256, mesh10k_512, mesh100k_512 and
               mesh600k_256 at their full bench configs: each planned once
               (its seconds printed on their own line: set-up, not render
               time), a warm-up pass, then one timed pass with its wall,
               seg/s and launches; segments within 1e-4 and the image sum
               within 1e-3 relative of the JAX anchors; the sphere field
               must launch the plan's K3 walk alone (the warp walk; the
               other walk's counters at 0), the ray sort must run on
               mesh100k and mesh600k, the plan's K1 / K2 walk alone (the
               warp walk on the meshes), and no plain version may run on
               the card;
  7. bounds  — the kernels at the paths' own shapes, on rays captured from
               the warm-up passes of phase 6 (every K3 launch of one
               sphere-field pass: 7 closest and 3 any hit, 262,144 rays
               each; a mesh10k and a mesh100k bounce 2 with its shadow rays;
               each shape's live lanes printed): both walks' and the plain
               ms, and the least time the card could take (bytes or
               operations, from the live lanes and the entered-tile counts
               of K1's stats and of the plain versions); K3's per-pass sum
               for each walk;
  8. probes  — the traversal-analysis path (curry_pbrt_tpu_torch/tools/):
               the group kernel K4 (closest and any hit) against its plain
               version and against K1 / K2 on the phase-3 soup at 32k rays
               (t bit-equal, any-hit equal, rows and prims equal up to
               exact-t ties); the K1 / K4 A/B on mesh10k and mesh100k at the
               render chunk (4,194,304 rays), depth 6, the same checks per
               bounce for K4 and for the per-thread walk, and each kernel's
               ms (K1 / K2 and the per-thread walk in turns); K4 at
               mesh10k's bounce 2 against its plain version, with its bound
               from K1's entered tiles;
               the roofline on cornell_tex and mesh10k; the granularity
               probe on mesh10k; the slab-grid probe P at the JAX shape and
               at 16,384 blocks x 7 slabs against its plain version (rtol
               1e-5);
and then prints the per-kernel JSON line and, last, the device line. Each
phase prints its seconds.

Imports nothing of JAX. Run from the repository root's checkout.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
if not (REPO / "curry_pbrt_tpu_torch" / "csrc").is_dir():
    raise SystemExit("chip_smoke: the curry_pbrt_tpu_torch package is not beside this script")
sys.path.insert(0, str(REPO))

# The least time the card could take (the larger of bytes over the memory
# rate and operations over the f32 rate of an H100 SXM, NVIDIA's data sheet
# at the 700 W limit), shared with the roofline tool.
from curry_pbrt_tpu_torch.tools.probe_group_kernel import non_tie_mismatches, row_t  # noqa: E402
from curry_pbrt_tpu_torch.tools.roofline import (  # noqa: E402
    SPHERE_TEST_OPS,
    TRI_TEST_OPS,
    bound,
    cuda_ms,
    least_ms,
    nvidia_smi,
    table_bytes,
    turns,
)

# JAX anchors (hardware-independent: traced segments and image checksum of
# the JAX package's bench run, BENCH_r05.json)
HEADLINE = dict(res=512, spp=64, depth=5)
ANCHOR_SEGMENTS = 155_670_944
ANCHOR_CHECKSUM = 86446.0
SEG_RTOL, SUM_RTOL = 1e-4, 1e-3
# name: (scene, res, spp, depth, anchor segments, anchor checksum)
CONFIGS = {
    "spherefield10k_256": ("spherefield10k.pbrt", 256, 4, 3, 1_243_639, 30907.0),
    "mesh10k_512": ("mesh10k.pbrt", 512, 16, 8, 11_243_977, 318225.1),
    "mesh100k_512": ("mesh100k.pbrt", 512, 16, 8, 11_251_281, 319003.6),
    "mesh600k_256": ("mesh600k.pbrt", 256, 4, 5, 703_314, 79705.3),
}
# slice tolerance: the CPU slice test's (tests/test_torch_render.py)
SLICE_RTOL = SLICE_ATOL = 1e-4
SLICE_MAX_OUTLIER_FRAC = 0.01
SLICE_SUM_RTOL = 1e-3

PROBE_DEPTH = 6  # bounces of the phase-8 workload


def log(msg: str) -> None:
    print(msg, flush=True)


class Phases:
    """Prints each phase's seconds as the next one starts."""

    def __init__(self):
        self.name, self.t0 = None, time.time()

    def start(self, name=None):
        if self.name:
            log(f"[seconds] phase {self.name}: {time.time() - self.t0:.1f} s")
        self.name, self.t0 = name, time.time()


def soup_tris(n_tris: int, seed: int):
    """A random soup of n_tris small triangles in a 16-unit box."""
    import numpy as np

    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-8, 8, (n_tris, 3)).astype(np.float32)
    p1 = p0 + rng.normal(0, 0.6, (n_tris, 3)).astype(np.float32)
    p2 = p0 + rng.normal(0, 0.6, (n_tris, 3)).astype(np.float32)
    return p0, p1, p2, np.arange(n_tris, dtype=np.int32)


def soup_tables(n_tris: int, seed: int):
    import numpy as np

    from curry_pbrt_tpu_torch.ops.kernels.intersect_kernel import build_tri_tables

    return build_tri_tables(*soup_tris(n_tris, seed), block_t=64, view_origin=np.zeros(3),
                            clusters_per_slab=16, use_supers=True)


def sphere_soup_tables(n: int, seed: int):
    """Randomly rotated, anisotropically scaled spheres (as
    tests/test_sphere_kernel.py makes them), with supers, several slabs and
    a NaN padding cluster."""
    import numpy as np

    from curry_pbrt_tpu_torch.ops.kernels.sphere_kernel import build_sphere_tables

    rng = np.random.default_rng(seed)
    centers = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    radii = rng.uniform(0.1, 0.6, n).astype(np.float32)
    o2w = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        o2w[i, :3, :3] = q @ np.diag(rng.uniform(0.7, 1.4, 3))
        o2w[i, :3, 3] = centers[i]
    w2o = np.linalg.inv(o2w).astype(np.float32)
    return build_sphere_tables(w2o, o2w, radii, np.arange(n, dtype=np.int32),
                               view_origin=np.zeros(3), clusters_per_slab=16, use_supers=True)


def on_surface(n: int, seed: int, device, n_small: int = 69):
    """A unit sphere at the origin among n_small small spheres, and n rays
    that start exactly on its surface — at (±1, 0, 0), (0, ±1, 0) and
    (0, 0, ±1), in random directions, every 7th lane dead — so every live
    ray hits it at t = ±0, at -0.0 where it leaves the sphere (c = +0 over
    q < 0). → (SphereTables, (o, d, t_max))."""
    import numpy as np
    import torch

    from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX
    from curry_pbrt_tpu_torch.ops.kernels.sphere_kernel import build_sphere_tables

    rng = np.random.default_rng(seed)
    o2w = np.tile(np.eye(4, dtype=np.float32), (n_small + 1, 1, 1))
    o2w[1:, :3, 3] = rng.uniform(-3, 3, (n_small, 3))
    radius = np.concatenate([[1.0], rng.uniform(0.1, 0.3, n_small)]).astype(np.float32)
    tables = build_sphere_tables(np.linalg.inv(o2w).astype(np.float32), o2w, radius,
                                 np.arange(n_small + 1, dtype=np.int32), view_origin=np.zeros(3))
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    o = axes[rng.integers(0, 6, n)]
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full((n,), FLOAT_MAX, np.float32)
    t_max[::7] = 0.0
    return tables, tuple(torch.from_numpy(a).to(device) for a in (o, d, t_max))


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


def sphere_row_t(tables, o, d, t_max, rows):
    """t of each ray against one given sphere row (-1 → FLOAT_MAX)."""
    import torch

    from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX
    from curry_pbrt_tpu_torch.ops.kernels.sphere_kernel import _sphere_tile_test

    t = torch.stack([_sphere_tile_test(tables.sph16[r:r + 1], o[i:i + 1], d[i:i + 1],
                                       t_max[i:i + 1])[0, 0]
                     for i, r in enumerate(rows.clamp(min=0).tolist())])
    return torch.where(rows >= 0, t, float(FLOAT_MAX))


def hold_closest(name, tables, rays, t_k, r_k, t_ref, r_ref, what):
    """K1's (t, row) against a reference's: hit masks equal, t bit-equal,
    rows equal up to exact-t ties, no hit on a dead lane. Returns the tie
    rows."""
    import torch

    o, d, t_max = rays
    hit_k, hit_r = r_k >= 0, r_ref >= 0
    if not torch.equal(hit_k, hit_r):
        raise AssertionError(f"{name}: {what} hit masks differ on "
                             f"{(hit_k != hit_r).sum().item()} rays")
    if not torch.equal(t_k, t_ref):
        bad = (t_k != t_ref)
        rel = ((t_k - t_ref).abs() / t_ref.abs().clamp(min=1e-30))[bad].max().item()
        raise AssertionError(f"{name}: {what} t not bit-equal on {bad.sum().item()} rays "
                             f"(max rel {rel:.3g})")
    diff = r_k != r_ref
    if diff.any():  # allowed only where both rows give the same t (a tie)
        tk = row_t(tables.tris16, o[diff], d[diff], t_max[diff], r_k[diff])
        tp = row_t(tables.tris16, o[diff], d[diff], t_max[diff], r_ref[diff])
        if not (torch.equal(tk, tp) and torch.equal(tk, t_k[diff])):
            raise AssertionError(f"{name}: {what} rows differ beyond exact-t ties")
    if hit_k[t_max == 0].any():
        raise AssertionError(f"{name}: a dead lane (t_max 0) reported a hit ({what})")
    return int(diff.sum())


def hold_any(name, h_k, h_ref, t_max, what):
    import torch

    if not torch.equal(h_k, h_ref):
        raise AssertionError(f"{name}: {what} differ on {(h_k != h_ref).sum().item()} rays")
    if h_k[t_max == 0].any():
        raise AssertionError(f"{name}: a dead lane (t_max 0) reported an any hit ({what})")


def check_kernels(name, tables, rays, K, plain, timing: bool):
    """K1 / K2 through both walks — the warp walk (csrc/intersect_warp.cu)
    and the per-thread walk (csrc/intersect.cu), whatever the plan picks for
    these tables — against the plain versions and against each other on one
    table set and ray batch; with timing, both walks' ms in turns and the
    plain versions' ms."""
    import torch

    o, d, t_max = rays
    n = o.shape[0]
    kw = tables.kw
    args = (o, d, t_max, tables.tris16, tables.caabb, tables.saabb, tables.slab_aabb)
    t_w, r_w = K.tri_closest_hit_warp(*args, **kw)
    h_w = K.tri_any_hit_warp(*args, **kw)
    t_t, r_t = K.tri_closest_hit_thread(*args, **kw)
    h_t = K.tri_any_hit_thread(*args, **kw)
    torch.cuda.synchronize()
    t_p, r_p = plain["closest"](*args, **kw)
    h_p = plain["any"](*args, **kw)
    ties = hold_closest(name, tables, rays, t_w, r_w, t_p, r_p, "warp K1 vs plain")
    hold_closest(name, tables, rays, t_t, r_t, t_p, r_p, "per-thread K1 vs plain")
    hold_closest(name, tables, rays, t_w, r_w, t_t, r_t, "warp K1 vs per-thread K1")
    hold_any(name, h_w, h_p, t_max, "warp K2 vs plain")
    hold_any(name, h_w, h_t, t_max, "warp K2 vs per-thread K2")
    hit = r_w >= 0
    log(f"  {name}: {n} rays ({int((t_max > 0).sum())} live), {int(hit.sum())} closest hits, "
        f"{int(h_w.sum())} any hits, {ties} tie rows — warp and per-thread walks: masks equal, "
        f"t bit-equal to the plain version and to each other, rows equal up to ties, K2 equal")
    err = lambda t: (t[hit] - t_p[hit]).abs().max().item() if hit.any() else 0.0  # noqa: E731
    any_err = lambda h: (h.float() - h_p.float()).abs().max().item() if n else 0.0  # noqa: E731
    out = {"max_abs_err": err(t_w), "thread_max_abs_err": err(t_t),
           "any_max_abs_err": any_err(h_w), "any_thread_max_abs_err": any_err(h_t)}
    if timing:
        out["closest_thread_ms"], out["closest_ms"] = turns(
            lambda: K.tri_closest_hit_thread(*args, **kw),
            lambda: K.tri_closest_hit_warp(*args, **kw), 20)
        out["any_thread_ms"], out["any_ms"] = turns(
            lambda: K.tri_any_hit_thread(*args, **kw),
            lambda: K.tri_any_hit_warp(*args, **kw), 20)
        out["closest_plain_ms"] = cuda_ms(lambda: plain["closest"](*args, **kw), 3)
        out["any_plain_ms"] = cuda_ms(lambda: plain["any"](*args, **kw), 3)
        log(f"    K1 warp {out['closest_ms']:.4f} ms, per-thread {out['closest_thread_ms']:.4f} "
            f"(plain {out['closest_plain_ms']:.3f}); K2 warp {out['any_ms']:.4f} ms, per-thread "
            f"{out['any_thread_ms']:.4f} (plain {out['any_plain_ms']:.3f})")
    return out


def tie_batch(tables, rays, plain):
    """rays with t_max set to each hit ray's own plain-version closest t:
    the first-hit-at-t_max rule decides every such ray."""
    import torch

    o, d, t_max = rays
    t_p, _ = plain["closest"](o, d, t_max, tables.tris16, tables.caabb, tables.saabb,
                              tables.slab_aabb, **tables.kw)
    return o, d, torch.where(t_p < 1e30, t_p, t_max)


def mostly_dead(rays, seed: int, live: float = 0.1):
    """rays with all but a `live` share of the lanes dead (t_max 0)."""
    import torch

    o, d, t_max = rays
    gen = torch.Generator(device=o.device).manual_seed(seed)
    keep = torch.rand(t_max.shape, generator=gen, device=o.device) < live
    return o, d, torch.where(keep, t_max, 0.0)


def hold_sphere_closest(name, tables, rays, t_k, r_k, t_ref, r_ref, what):
    """K3's (t, row) against a reference's: hit masks equal, t bit-equal
    with its sign bit (a ray that starts on a sphere and leaves it hits at
    -0.0), spheres equal up to exact-t ties, no hit on a dead lane. Returns
    the tie spheres."""
    import torch

    o, d, t_max = rays
    hit_k, hit_r = r_k >= 0, r_ref >= 0
    if not torch.equal(hit_k, hit_r):
        raise AssertionError(f"{name}: {what} hit masks differ on "
                             f"{(hit_k != hit_r).sum().item()} rays")
    if not torch.equal(t_k.view(torch.int32), t_ref.view(torch.int32)):
        raise AssertionError(f"{name}: {what} t not bit-equal on "
                             f"{(t_k.view(torch.int32) != t_ref.view(torch.int32)).sum().item()} rays")
    diff = (r_k != r_ref) & (tables.row_sphere[r_k.clamp(min=0).long()]
                             != tables.row_sphere[r_ref.clamp(min=0).long()])
    if diff.any():  # different spheres only where both give the same t (a tie)
        tk = sphere_row_t(tables, o[diff], d[diff], t_max[diff], r_k[diff])
        tp = sphere_row_t(tables, o[diff], d[diff], t_max[diff], r_ref[diff])
        if not (torch.equal(tk, tp) and torch.equal(tk, t_k[diff])):
            raise AssertionError(f"{name}: {what} spheres differ beyond exact-t ties")
    if hit_k[t_max == 0].any():
        raise AssertionError(f"{name}: a dead lane (t_max 0) reported a sphere hit ({what})")
    return int(diff.sum())


def check_sphere_kernels(name, tables, rays, S, plain, reps=(20, 3), timed=("closest", "any")):
    """K3 (closest and any hit) through both walks — the warp walk
    (csrc/intersect_warp.cu) and the per-thread walk (csrc/intersect.cu) —
    against the plain versions and each other on one sphere table set and
    ray batch; returns errors, the -0.0 hits, the plain versions'
    entered-tile sums (the bound's input) and, with reps, the `timed`
    kernels' ms: both walks in turns, and the plain version's."""
    import torch

    o, d, t_max = rays
    n = o.shape[0]
    args = (o, d, t_max, tables.sph16, tables.caabb, tables.saabb, tables.slab_aabb)
    kw = tables.kw
    t_w, r_w = S.sphere_closest_hit_warp(*args, **kw)
    h_w = S.sphere_any_hit_warp(*args, **kw)
    t_t, r_t = S.sphere_closest_hit_thread(*args, **kw)
    h_t = S.sphere_any_hit_thread(*args, **kw)
    torch.cuda.synchronize()
    t_p, r_p, entered, _ = plain["sphere_closest"](*args, **kw, stats=True)
    h_p, any_entered = plain["sphere_any"](*args, **kw, stats=True)
    ties = hold_sphere_closest(name, tables, rays, t_w, r_w, t_p, r_p, "warp K3 vs plain")
    hold_sphere_closest(name, tables, rays, t_t, r_t, t_p, r_p, "per-thread K3 vs plain")
    hold_sphere_closest(name, tables, rays, t_w, r_w, t_t, r_t, "warp K3 vs per-thread K3")
    hold_any(name, h_w, h_p, t_max, "warp K3 any-hit vs plain")
    hold_any(name, h_t, h_p, t_max, "per-thread K3 any-hit vs plain")
    hit = r_w >= 0
    neg_zero = int((hit & (t_w == 0) & torch.signbit(t_w)).sum())
    log(f"  {name}: {n} rays ({int((t_max > 0).sum())} live), {int(hit.sum())} closest hits "
        f"({neg_zero} at -0.0), {int(h_w.sum())} any hits, {ties} tie spheres — warp and "
        f"per-thread walks: masks equal, t bit-equal (sign included) to the plain version and to "
        f"each other, spheres equal up to ties, any-hit equal")
    err = lambda t: (t[hit] - t_p[hit]).abs().max().item() if hit.any() else 0.0  # noqa: E731
    any_err = lambda h: (h.float() - h_p.float()).abs().max().item() if n else 0.0  # noqa: E731
    out = {"max_abs_err": err(t_w), "thread_max_abs_err": err(t_t),
           "any_max_abs_err": any_err(h_w), "any_thread_max_abs_err": any_err(h_t),
           "entered": int(entered.sum()), "any_entered": int(any_entered.sum()), "n": n,
           "live": int((t_max > 0).sum()), "neg_zero": neg_zero,
           "table_bytes": table_bytes(*args[3:])}
    if reps:
        fns = {"closest": (S.sphere_closest_hit_thread, S.sphere_closest_hit_warp,
                           plain["sphere_closest"]),
               "any": (S.sphere_any_hit_thread, S.sphere_any_hit_warp, plain["sphere_any"])}
        for kind in timed:
            thread, warp, pl = fns[kind]
            out[kind + "_thread_ms"], out[kind + "_ms"] = turns(
                lambda: thread(*args, **kw), lambda: warp(*args, **kw), reps[0])
            out[kind + "_plain_ms"] = cuda_ms(lambda: pl(*args, **kw), reps[1])
            log(f"    K3 {kind} warp {out[kind + '_ms']:.4f} ms, per-thread "
                f"{out[kind + '_thread_ms']:.4f} (plain {out[kind + '_plain_ms']:.3f})")
    return out


def check_stats(name, tables, rays, K, plain, reps=None):
    """K1 stats=True through both walks vs the plain version's stats (and t
    bit-equal to it); returns the entered-tile sum and, with reps, both
    walks' times with and without stats (in turns) and the plain ones."""
    import torch

    o, d, t_max = rays
    args = (o, d, t_max, tables.tris16, tables.caabb, tables.saabb, tables.slab_aabb)
    kw = tables.kw
    t_p, r_p, ent_p, imp_p = plain["closest"](*args, **kw, stats=True)
    hit = r_p >= 0
    err = lambda t: (t[hit] - t_p[hit]).abs().max().item() if hit.any() else 0.0  # noqa: E731
    errs = {}
    for walk, fn, sfx in (("warp", K.tri_closest_hit_warp, ""),
                          ("per-thread", K.tri_closest_hit_thread, "thread_")):
        t0, r0 = fn(*args, **kw)
        t1, r1, ent_k, imp_k = fn(*args, **kw, stats=True)
        torch.cuda.synchronize()
        if not (torch.equal(t0, t1) and torch.equal(r0, r1)):
            raise AssertionError(f"{name}: stats=True changed the {walk} K1's (t, row)")
        hold_closest(name, tables, rays, t1, r1, t_p, r_p, f"{walk} K1 (stats) vs plain")
        if not (torch.equal(ent_k, ent_p) and torch.equal(imp_k, imp_p)):
            raise AssertionError(f"{name}: {walk} K1 stats differ from the plain stats on "
                                 f"{int(((ent_k != ent_p) | (imp_k != imp_p)).sum())} rays")
        errs[sfx + "max_abs_err"], errs["stats_" + sfx + "max_abs_err"] = err(t0), err(t1)
    if (imp_p > ent_p).any() or int(ent_p.max()) > tables.caabb.shape[0]:
        raise AssertionError(f"{name}: stats break improved <= entered <= n_clusters")
    out = {"entered": int(ent_p.sum()), "improved": int(imp_p.sum()), "n": o.shape[0],
           "live": int((t_max > 0).sum()), "table_bytes": table_bytes(*args[3:]),
           "block": kw["block_t"], **errs}
    log(f"  {name}: {o.shape[0]} rays ({out['live']} live), entered tiles {out['entered']} "
        f"({out['entered'] / o.shape[0]:.2f}/ray of {tables.caabb.shape[0]} clusters), "
        f"improved {out['improved']} — warp and per-thread stats equal to the plain stats, "
        f"t bit-equal, (t, row) unchanged by stats")
    if reps:
        out["thread_ms"], out["ms"] = turns(lambda: K.tri_closest_hit_thread(*args, **kw),
                                            lambda: K.tri_closest_hit_warp(*args, **kw), reps[0])
        out["stats_thread_ms"], out["stats_ms"] = turns(
            lambda: K.tri_closest_hit_thread(*args, **kw, stats=True),
            lambda: K.tri_closest_hit_warp(*args, **kw, stats=True), reps[0])
        out["plain_ms"] = cuda_ms(lambda: plain["closest"](*args, **kw), reps[1])
        out["stats_plain_ms"] = cuda_ms(lambda: plain["closest"](*args, **kw, stats=True),
                                        reps[1])
    return out


def check_any(name, tables, rays, K, plain, reps):
    """K2 through both walks vs the plain version on one batch (shadow
    rays); returns the plain version's entered tiles (the bound's input) and
    both walks' times in turns and the plain one's."""
    import torch

    o, d, t_max = rays
    args = (o, d, t_max, tables.tris16, tables.caabb, tables.saabb, tables.slab_aabb)
    kw = tables.kw
    h_w = K.tri_any_hit_warp(*args, **kw)
    h_t = K.tri_any_hit_thread(*args, **kw)
    torch.cuda.synchronize()
    h_p, entered = plain["any"](*args, **kw, stats=True)
    hold_any(name, h_w, h_p, t_max, "warp K2 vs plain")
    hold_any(name, h_t, h_p, t_max, "per-thread K2 vs plain")
    err = lambda h: (h.float() - h_p.float()).abs().max().item() if h.numel() else 0.0  # noqa: E731
    out = {"any_entered": int(entered.sum()), "n": o.shape[0], "live": int((t_max > 0).sum()),
           "hits": int(h_w.sum()), "table_bytes": table_bytes(*args[3:]), "block": kw["block_t"],
           "max_abs_err": err(h_w), "thread_max_abs_err": err(h_t)}
    out["thread_ms"], out["ms"] = turns(lambda: K.tri_any_hit_thread(*args, **kw),
                                        lambda: K.tri_any_hit_warp(*args, **kw), reps[0])
    out["plain_ms"] = cuda_ms(lambda: plain["any"](*args, **kw), reps[1])
    log(f"  {name}: {out['n']} rays ({out['live']} live), {out['hits']} any hits, "
        f"{out['any_entered']} entered tiles (plain) — warp and per-thread K2 equal to the plain "
        f"version")
    return out


def check_group(name, gtab, ktab, gprim, kprim, rays, G, t_any=None, plain_reps=None):
    """K4 (closest and any hit) against its plain version and against K1 /
    K2 (ktab) on one ray batch: t bit-equal to the plain version's and to
    K1's, any-hit equal to both, rows equal to the plain version's up to
    exact-t ties, prims equal to K1's (through each table's prim) up to
    exact-t ties. t_any: the any-hit bound (t_max by default). Returns the
    errors, the plain versions' group-granular entered tiles and, with
    plain_reps, the plain versions' ms."""
    import torch

    o, d, t_max = rays
    t_any = t_max if t_any is None else t_any
    kw = G.group_kw(gtab)
    c_args = (o, d, t_max, gtab.tris16, gtab.caabb, gtab.saabb, gtab.slab_aabb)
    a_args = (o, d, t_any) + c_args[3:]
    t4, r4 = G.tri_closest_hit_groups(*c_args, **kw)
    h4 = G.tri_any_hit_groups(*a_args, **kw)
    t1, r1 = ktab.closest(o, d, t_max)
    h2 = ktab.any_hit(o, d, t_any)
    torch.cuda.synchronize()
    t_p, r_p, ent8, _ = G.tri_closest_hit_groups_plain(*c_args, **kw, stats=True)
    h_p, any_ent8 = G.tri_any_hit_groups_plain(*a_args, **kw, stats=True)
    if not torch.equal(t4, t_p):
        raise AssertionError(f"{name}: K4 t not bit-equal to its plain version on "
                             f"{int((t4 != t_p).sum())} rays")
    if not (torch.equal(h4, h_p) and torch.equal(h4, h2)):
        raise AssertionError(f"{name}: K4 any-hit differs from its plain version on "
                             f"{int((h4 != h_p).sum())} rays, from K2 on {int((h4 != h2).sum())}")
    if not torch.equal(t4, t1):
        raise AssertionError(f"{name}: K4 t not bit-equal to K1's on {int((t4 != t1).sum())} rays")
    diff = r4 != r_p
    if diff.any():  # allowed only where both rows give the same t (a tie)
        tk = row_t(gtab.tris16, o[diff], d[diff], t_max[diff], r4[diff])
        tp = row_t(gtab.tris16, o[diff], d[diff], t_max[diff], r_p[diff])
        if not (torch.equal(tk, tp) and torch.equal(tk, t4[diff])):
            raise AssertionError(f"{name}: K4 rows differ from the plain version's beyond ties")
    n_mis, n_bad = non_tie_mismatches(ktab, kprim, r1, gtab, gprim, r4, o, d, t_max)
    if n_bad:
        raise AssertionError(f"{name}: K4 prims differ from K1's beyond exact-t ties on {n_bad} rays")
    if (r4[t_max == 0] >= 0).any() or h4[t_any == 0].any():
        raise AssertionError(f"{name}: a dead lane (t_max 0) reported a K4 hit")
    hit = r4 >= 0
    log(f"  {name}: {o.shape[0]} rays, {int(hit.sum())} closest hits, {int(h4.sum())} any hits, "
        f"{int(diff.sum())} tie rows vs plain, {n_mis} tie prims vs K1 — K4 t bit-equal to its "
        f"plain version and to K1, any-hit equal to its plain version and to K2")
    out = {"max_abs_err": (t4[hit] - t_p[hit]).abs().max().item() if hit.any() else 0.0,
           "any_max_abs_err": (h4.float() - h_p.float()).abs().max().item() if h4.numel() else 0.0,
           "group_entered": int(ent8.sum()), "group_any_entered": int(any_ent8.sum()),
           "n": o.shape[0], "live": int((t_max > 0).sum()), "any_live": int((t_any > 0).sum()),
           "table_bytes": table_bytes(*c_args[3:])}
    if plain_reps:
        out["plain_ms"] = cuda_ms(lambda: G.tri_closest_hit_groups_plain(*c_args, **kw), plain_reps)
        out["any_plain_ms"] = cuda_ms(lambda: G.tri_any_hit_groups_plain(*a_args, **kw),
                                      plain_reps)
    return out


def main() -> int:
    t_start = time.time()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — this needs a GPU")
    phases = Phases()

    # ---- 1. device
    phases.start("1 device")
    card = nvidia_smi("name,power.limit")
    log(card)  # the card's name and power limit, as nvidia-smi gives them
    from curry_pbrt_tpu_torch.ops.kernels import build

    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    log(f"[device] torch {torch.__version__} (CUDA {torch.version.cuda}), nvcc: {nvcc}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    # ---- 2. build
    phases.start("2 build")
    t0 = time.time()
    build.build(verbose=True)
    build.load_library()
    log(f"[build] nvcc {' '.join(build.NVCC_FLAGS)}: {time.time() - t0:.1f} s")

    # ---- 3. kernels against their plain versions
    phases.start("3 kernels")
    from curry_pbrt_tpu_torch.ops.kernels import aggregate as AG
    from curry_pbrt_tpu_torch.ops.kernels import intersect_kernel as K
    from curry_pbrt_tpu_torch.ops.kernels import sphere_kernel as S
    from curry_pbrt_tpu_torch.ops.kernels.aggregate import plan_tri_kernel
    from curry_pbrt_tpu_torch.render import CHUNK_RAYS
    from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file

    plain = {"closest": K.tri_closest_hit_plain, "any": K.tri_any_hit_plain,
             "sphere_closest": S.sphere_closest_hit_plain, "sphere_any": S.sphere_any_hit_plain}
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
    log(f"[kernels] launch plans: cornell_tex the {ctab.plan} walk, soup the {stab.plan} walk")
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
    # t_max at each ray's exact hit t (the first-hit-at-t_max rule), and
    # ~90% dead lanes at the render chunk
    for tname, tab, c, spread in (("cornell_tex", ctab, box_c, 280.0),
                                  ("soup5k", stab, (0, 0, 0), 9.0)):
        check_kernels(f"{tname}/32768 t_max = hit t", tab,
                      tie_batch(tab, make_rays(1 << 15, 70, c, spread, dev), plain), K, plain,
                      timing=False)
    timings[("soup 90% dead", chunk)] = check_kernels(
        f"soup5k/{chunk} 90% dead", stab, mostly_dead(make_rays(chunk, 71, (0, 0, 0), 9.0, dev), 72),
        K, plain, timing=True)
    # the headline shape's entered tiles, for the K1/K2 bounds
    head_rays = make_rays(chunk, 10 + chunk % 97, box_c, 280.0, dev)
    head_stats = check_stats(f"cornell_tex/{chunk} stats", ctab, head_rays, K, plain)
    hs = timings[("cornell", chunk)]
    log(f"[kernels] the plan at block_t 8 (PER_THREAD_MAX_BLOCK_T {K.PER_THREAD_MAX_BLOCK_T}): "
        f"headline shape K1 warp {hs['closest_ms']:.4f} ms vs per-thread "
        f"{hs['closest_thread_ms']:.4f}, K2 warp {hs['any_ms']:.4f} vs per-thread "
        f"{hs['any_thread_ms']:.4f} — the per-thread walk "
        f"{'is faster there, as the plan assumes' if hs['closest_thread_ms'] < hs['closest_ms'] else 'is NOT faster there: revisit the plan'}")
    _, head_any_entered = plain["any"](*head_rays, ctab.tris16, ctab.caabb, ctab.saabb,
                                       ctab.slab_aabb, **ctab.kw, stats=True)
    head_any_entered = int(head_any_entered.sum())

    # ---- 3b. the sphere kernels against their plain versions
    phases.start("3b spheres")
    scenes = {}  # config name → (compiled scene, compile seconds), compiled once

    def config_scene(name):
        if name not in scenes:
            fname, cres, cspp, cdepth = CONFIGS[name][:4]
            t0 = time.time()
            scenes[name] = (compile_scene_file(REPO / "scenes" / fname, overrides={
                "resolution": (cres, cres), "spp": cspp, "max_depth": cdepth}), time.time() - t0)
        return scenes[name][0]

    t0 = time.time()
    field = config_scene("spherefield10k_256")
    field_cam = np.asarray(field.camera.camera_to_world)[:3, 3]
    ftab_host = S.build_sphere_tables(field.spheres.w2o, field.spheres.o2w, field.spheres.radius,
                                      field.spheres.prim, view_origin=field_cam)
    ftab = S.DeviceSphereTables(ftab_host, dev)
    qtab_host = sphere_soup_tables(3000, seed=3)
    qtab = S.DeviceSphereTables(qtab_host, dev)
    log(f"[spheres] spherefield10k: {int((field.spheres.prim >= 0).sum())} spheres, "
        f"{ftab_host.cluster_aabbs.shape[0]} clusters of {ftab_host.block_s}, "
        f"{ftab_host.slab_aabbs.shape[0]} slab(s), supers {ftab_host.use_supers}; soup: "
        f"{qtab_host.cluster_aabbs.shape[0]} clusters, {qtab_host.slab_aabbs.shape[0]} slabs, "
        f"supers {qtab_host.use_supers}, "
        f"{int(np.isnan(qtab_host.cluster_aabbs[:, 0]).sum())} NaN padding clusters "
        f"(compile + tables {time.time() - t0:.1f} s)")
    log(f"[spheres] launch plan: spherefield10k the {ftab.plan} walk, soup the {qtab.plan} walk")
    field_res, field_spp = CONFIGS["spherefield10k_256"][1:3]
    field_chunk = field_res * field_res * field_spp
    sph_timings = {}
    for n in (1 << 15, field_chunk, 1 << 20):
        sph_timings[("field", n)] = check_sphere_kernels(
            f"spherefield10k/{n}", ftab, make_rays(n, 30 + n % 83, (0, 0, 0), 45.0, dev), S,
            plain)
        sph_timings[("soup", n)] = check_sphere_kernels(
            f"sphere soup/{n}", qtab, make_rays(n, 40 + n % 79, (0, 0, 0), 14.0, dev), S, plain)
    # t_max at each ray's exact hit t, ~90% dead lanes at the chunk shape,
    # and rays that start on a sphere's surface (hits at -0.0)
    for sname, tab, spread in (("spherefield10k", ftab, 45.0), ("sphere soup", qtab, 14.0)):
        rays = make_rays(1 << 15, 80, (0, 0, 0), spread, dev)
        t_p, _ = plain["sphere_closest"](*rays, tab.sph16, tab.caabb, tab.saabb, tab.slab_aabb,
                                         **tab.kw)
        check_sphere_kernels(f"{sname}/32768 t_max = hit t", tab,
                             (rays[0], rays[1], torch.where(t_p < 1e30, t_p, rays[2])), S, plain,
                             reps=None)
    sph_timings[("field 90% dead", field_chunk)] = check_sphere_kernels(
        f"spherefield10k/{field_chunk} 90% dead", ftab,
        mostly_dead(make_rays(field_chunk, 81, (0, 0, 0), 45.0, dev), 82), S, plain)
    otab_host, orays = on_surface(1 << 15, 83, dev)
    surf = check_sphere_kernels("on-surface/32768", S.DeviceSphereTables(otab_host, dev), orays,
                                S, plain, reps=None)
    if surf["neg_zero"] < 1000:
        raise AssertionError(f"the on-surface batch gave {surf['neg_zero']} hits at -0.0: it "
                             f"does not test the sign of t")

    # ---- 3c. K1 stats against the plain stats
    phases.start("3c stats")
    t0 = time.time()
    m100 = config_scene("mesh100k_512")
    m100_cam = np.asarray(m100.camera.camera_to_world)[:3, 3]
    mtab_host = plan_tri_kernel(m100.tris, m100_cam)
    mtab = K.DeviceTables(mtab_host, dev)
    log(f"[stats] mesh100k tables: {m100.tris.count} tris, {mtab_host.cluster_aabbs.shape[0]} "
        f"clusters of {mtab_host.block_t}, {mtab_host.n_slabs} slabs "
        f"(compile + plan {time.time() - t0:.1f} s)")
    check_stats("soup5k/1048576", stab, make_rays(1 << 20, 50, (0, 0, 0), 9.0, dev), K, plain)
    check_stats("mesh100k/262144", mtab, make_rays(1 << 18, 51, (0, 0.5, 0), 3.0, dev), K, plain)

    # ---- 4. the slice at test size, on the card
    phases.start("4 slice")
    from curry_pbrt_tpu_torch.render import plan_render, render_plan, render_scene

    calls = {"plain": 0}

    def walk_counters(walk):
        """(the K1 / K2 counters of `walk`, those of the other walk)."""
        sfx = {"warp": ("", "_thread"), "thread": ("_thread", "")}[walk]
        return tuple(("tri_closest" + x, "tri_any" + x) for x in sfx)

    def ran_alone(launches, walk):
        """The path's K1 / K2 walk launched, the other walk and the plain
        versions did not run on the card."""
        need, off = walk_counters(walk)
        return min(launches[k] for k in need) > 0 and not any(launches[k] for k in off) \
            and not calls["plain"]

    def forbid(fn):
        def wrapped(o, *a, **kw):
            if o.device.type == "cuda":
                calls["plain"] += 1
            return fn(o, *a, **kw)
        return wrapped

    K.tri_closest_hit_plain = forbid(plain["closest"])
    K.tri_any_hit_plain = forbid(plain["any"])
    S.sphere_closest_hit_plain = forbid(plain["sphere_closest"])
    S.sphere_any_hit_plain = forbid(plain["sphere_any"])
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
    if not ran_alone(launches_small, ctab.plan):
        raise AssertionError(f"the slice did not run through the plan's K1 / K2 "
                             f"({ctab.plan} walk) alone")
    img_cpu = render_scene(small, device="cpu", show_progress=False)
    cpu_close = np.isclose(img, img_cpu, rtol=SLICE_RTOL, atol=SLICE_ATOL)
    log(f"[slice] card vs the port on the CPU (plain versions): max |Δ| "
        f"{np.abs(img - img_cpu).max():.3g}, {int((img != img_cpu).sum())} of {img.size} values "
        f"differ, {1.0 - cpu_close.mean():.4%} outside rtol=atol={SLICE_RTOL}")
    if 1.0 - cpu_close.mean() > SLICE_MAX_OUTLIER_FRAC:
        raise AssertionError("the card's slice render disagrees with the port's CPU render")

    # ---- 5. headline
    phases.start("5 headline")
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
    launches = head_launches = dict(K.LAUNCHES)
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
    if not ran_alone(launches, ctab.plan):
        raise AssertionError(f"the headline did not run through the plan's K1 / K2 "
                             f"({ctab.plan} walk) alone")

    # ---- 6. the sphere-field and mesh configs
    phases.start("6 configs")
    # capture: the inputs of the warm-up passes' traversals for phase 7 —
    # (config, kernel, call number) → (o, d, t_max)
    captured = {}
    capture = {}

    def capturing(fn, key):
        def wrapped(o, d, t_max, *a, **kw):
            call = capture["calls"][key] = capture["calls"].get(key, 0) + 1
            if capture.get(key) in (call, "all"):
                captured[(capture["config"], key, call)] = (o.clone(), d.clone(), t_max.clone())
            return fn(o, d, t_max, *a, **kw)
        return wrapped

    K.tri_closest_hit_tables = capturing(K.tri_closest_hit_tables, "tri_closest")
    K.tri_any_hit_tables = capturing(K.tri_any_hit_tables, "tri_any")
    S.sphere_closest_hit_tables = capturing(S.sphere_closest_hit_tables, "sphere_closest")
    S.sphere_any_hit_tables = capturing(S.sphere_any_hit_tables, "sphere_any")
    # closest-hit calls per bounce: the hit, then the MIS leg's (t, prim),
    # and after the last bounce the final hit; so call 3 is bounce 1's hit
    # (2 for the any-hit shadow rays), and call 5 bounce 2's (3 for its
    # shadow rays). The sphere field: every K3 call of the pass.
    capture_at = {"spherefield10k_256": {"sphere_closest": "all", "sphere_any": "all"},
                  "mesh10k_512": {"tri_closest": 5, "tri_any": 3},
                  "mesh100k_512": {"tri_closest": 5, "tri_any": 3}}
    config_runs = {}
    for name, (fname, cres, cspp, cdepth, a_seg, a_sum) in CONFIGS.items():
        sc = config_scene(name)
        t_compile = scenes[name][1]
        t0 = time.time()
        plan = plan_render(sc, device="cuda")
        torch.cuda.synchronize()
        t_plan = time.time() - t0
        log(f"[configs] {name}: set-up, not render time: scene compile {t_compile:.2f} s, "
            f"plan (tables, shading context) {t_plan:.2f} s; {sc.tris.count} tris, "
            f"{int((np.asarray(sc.spheres.prim) >= 0).sum())} spheres, "
            f"{len(plan.ctx.families)} material families "
            f"(largest {max(len(f.members) for f in plan.ctx.families)} members)")
        capture.clear()
        capture.update(capture_at.get(name, {}), config=name, calls={})
        render_plan(plan, show_progress=False)  # warm-up
        torch.cuda.synchronize()
        capture.clear()
        capture.update(config=None, calls={})
        K.reset_launches()  # counts of this path's run start here
        AG.RAY_SORTS["traversals"] = 0
        t0 = time.time()
        img, segments = render_plan(plan, show_progress=False, count_rays=True)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(K.LAUNCHES)
        sorts = AG.RAY_SORTS["traversals"]
        checksum = float(img.astype(np.float64).sum())
        seg_rel = abs(segments - a_seg) / a_seg
        sum_rel = abs(checksum - a_sum) / a_sum
        config_runs[name] = dict(wall=wall, segments=segments, launches=launches, sorts=sorts)
        log(f"[configs] {name} ({fname}, {cres}², {cspp} spp, depth {cdepth}) on {card}: "
            f"render wall {wall:.3f} s (plan excluded), {segments} segments "
            f"({segments / wall:.4g} seg/s), checksum {checksum:.2f}; vs JAX anchors "
            f"{a_seg} / {a_sum}: segments rel {seg_rel:.3g} (≤ {SEG_RTOL}), checksum rel "
            f"{sum_rel:.3g} (≤ {SUM_RTOL}); launches {launches}, sorted traversals {sorts}, "
            f"plain calls on CUDA {calls['plain']}")
        if img.shape != (cres, cres, 3) or not np.isfinite(img).all():
            raise AssertionError(f"{name}: image has the wrong shape or non-finite values")
        if seg_rel > SEG_RTOL or sum_rel > SUM_RTOL:
            raise AssertionError(f"{name} disagrees with the JAX anchors")
        if calls["plain"]:
            raise AssertionError(f"{name}: a plain version ran on the card")
        # the plan's walk: 8-row clusters (aggregate.plan_tri_kernel's small
        # scenes) keep the per-thread walk (launch_plan)
        walk = "thread" if sc.tris.count <= AG.SMALL_SCENE_TRIS else "warp"
        if not ran_alone(launches, walk):
            raise AssertionError(f"{name} did not run through the {walk} walk's K1 / K2 alone")
        if name.startswith("sphere"):  # the plan's K3 walk alone
            need, off = (("sphere_closest" + x, "sphere_any" + x)
                         for x in {"warp": ("", "_thread"), "thread": ("_thread", "")}[ftab.plan])
            if min(launches[k] for k in need) <= 0 or any(launches[k] for k in off):
                raise AssertionError(f"{name} did not run through the {ftab.plan} walk's K3 "
                                     f"alone: {launches}")
        if name in ("mesh100k_512", "mesh600k_256") and sorts <= 0:
            raise AssertionError(f"{name}: the ray sort did not run")
        del plan

    # ---- 7. the kernels at the paths' own shapes, and their bounds
    phases.start("7 bounds")
    K.reset_launches()  # the stats kernel's and the per-thread K3's path: this phase
    # every K3 launch of one sphere-field pass, in launch order: closest
    # calls 1 to 2·depth + 1 (bounce b's hit is call 2b + 1, its MIS leg
    # 2b + 2, the last call the final hit) and any-hit calls 1 to depth
    # (bounce b's shadow rays, b + 1)
    def k3_call(kind, call):
        if kind == "any":
            return f"bounce {call - 1} shadow rays"
        b, mis = divmod(call - 1, 2)
        return {1: "bounce 0 hit: camera rays", 2 * field_depth + 1: "final hit"}.get(
            call, f"bounce {b} {'MIS leg' if mis else 'hit'}")

    field_depth = CONFIGS["spherefield10k_256"][3]

    k3_pass = {}
    for kind, out_b, ent in (("closest", 8, "entered"), ("any", 1, "any_entered")):
        calls = sorted(c for cfg, key, c in captured
                       if cfg == "spherefield10k_256" and key == "sphere_" + kind)
        if len(calls) != config_runs["spherefield10k_256"]["launches"]["sphere_" + kind]:
            raise AssertionError(f"phase 7 holds {len(calls)} K3 {kind} calls of the sphere "
                                 f"field's pass, which launched a different number")
        for call in calls:
            what = k3_call(kind, call)
            st = check_sphere_kernels(
                f"spherefield10k {kind} call {call} ({what})", ftab,
                captured[("spherefield10k_256", "sphere_" + kind, call)], S, plain,
                reps=(10, 1), timed=(kind,))
            st["bound"] = bound(st["n"], st["live"], out_b, st["table_bytes"], st[ent],
                                ftab.kw["block_s"], SPHERE_TEST_OPS)
            k3_pass[(kind, call)] = st
            log(f"[bounds] K3 {kind} at the sphere field's call {call} ({what}; {st['n']} rays, "
                f"{st['live']} live) on {card}: warp {st[kind + '_ms']:.4f} ms, per-thread "
                f"{st[kind + '_thread_ms']:.4f} ms (plain {st[kind + '_plain_ms']:.3f}), bound "
                f"{st['bound'][0]:.4f} ms ({st['bound'][1]}; {st[ent]} entered tiles)")
    k3_sum = {w: sum(st[k + sfx + "_ms"] for (k, _), st in k3_pass.items())
              for w, sfx in (("warp", ""), ("thread", "_thread"), ("plain", "_plain"))}
    k3_sum["bound"] = sum(st["bound"][0] for st in k3_pass.values())
    faster = "warp" if k3_sum["warp"] < k3_sum["thread"] else "thread"
    log(f"[bounds] K3 per sphere-field pass ({len(k3_pass)} launches) on "
        f"{card}: warp {k3_sum['warp']:.4f} ms, per-thread {k3_sum['thread']:.4f} ms, plain "
        f"{k3_sum['plain']:.2f} ms, bound {k3_sum['bound']:.4f} ms — the plan's walk "
        f"({ftab.plan}) "
        f"{'has the lower sum, as the plan assumes' if faster == ftab.plan else 'does NOT have the lower sum: revisit the plan'}")
    k3_thread_launches = (K.LAUNCHES["sphere_closest_thread"], K.LAUNCHES["sphere_any_thread"])
    f_cl, f_any = k3_pass[("closest", 3)], k3_pass[("any", 2)]  # bounce 1
    mesh_rows, mesh_any = {}, {}
    for name in ("mesh10k_512", "mesh100k_512"):
        sc = config_scene(name)
        tab = mtab if name == "mesh100k_512" else K.DeviceTables(
            plan_tri_kernel(sc.tris, np.asarray(sc.camera.camera_to_world)[:3, 3]), dev)
        mesh_rows[name] = check_stats(f"{name} bounce 2", tab,
                                      captured[(name, "tri_closest", 5)], K, plain, reps=(5, 1))
        mesh_any[name] = check_any(f"{name} bounce-2 shadow rays", tab,
                                   captured[(name, "tri_any", 3)], K, plain, reps=(5, 1))
    stats_launches = K.LAUNCHES["tri_closest_stats"]
    stats_thread_launches = K.LAUNCHES["tri_closest_stats_thread"]

    # every bound counts a live ray's o, d and t_max and a dead ray's t_max
    def k1_bound(st, out_b=8):
        return bound(st["n"], st["live"], out_b, st["table_bytes"], st["entered"], st["block"],
                     TRI_TEST_OPS)

    def k2_bound(st):
        return bound(st["n"], st["live"], 1, st["table_bytes"], st["any_entered"], st["block"],
                     TRI_TEST_OPS)

    head_shape = timings[("cornell", chunk)]
    k1_b = k1_bound(head_stats)
    k2_b = k2_bound(dict(head_stats, any_entered=head_any_entered))
    k3c_b, k3a_b = f_cl["bound"], f_any["bound"]
    st100, any100 = mesh_rows["mesh100k_512"], mesh_any["mesh100k_512"]
    k1_100_b = k1_bound(st100)
    k2_100_b = k2_bound(any100)
    k1s_b = k1_bound(st100, out_b=16)
    log(f"[bounds] on {card}: K1 headline shape ({chunk} rays; the plan's walk there: "
        f"{ctab.plan}): per-thread {head_shape['closest_thread_ms']:.4f} ms, warp "
        f"{head_shape['closest_ms']:.4f} ms, bound {k1_b[0]:.4f} ms ({k1_b[1]}; "
        f"{head_stats['entered']} entered tiles); K2 per-thread {head_shape['any_thread_ms']:.4f} "
        f"ms, warp {head_shape['any_ms']:.4f} ms, bound {k2_b[0]:.4f} ms ({k2_b[1]}; "
        f"{head_any_entered} entered tiles)")
    for name, st in mesh_rows.items():
        b = k1_bound(st)
        log(f"[bounds] K1 at {name}'s bounce-2 shape ({st['n']} rays, {st['live']} live): warp "
            f"{st['ms']:.4f} ms, per-thread {st['thread_ms']:.4f} ms (plain {st['plain_ms']:.3f}), "
            f"bound {b[0]:.4f} ms ({b[1]}; {st['entered']} entered tiles, "
            f"{st['entered'] / st['n']:.2f}/ray); with stats warp {st['stats_ms']:.4f} ms, "
            f"per-thread {st['stats_thread_ms']:.4f} ms (plain {st['stats_plain_ms']:.3f})")
        sa = mesh_any[name]
        b = k2_bound(sa)
        log(f"[bounds] K2 at {name}'s bounce-2 shadow shape ({sa['n']} rays, {sa['live']} live): "
            f"warp {sa['ms']:.4f} ms, per-thread {sa['thread_ms']:.4f} ms (plain "
            f"{sa['plain_ms']:.3f}), bound {b[0]:.4f} ms ({b[1]}; {sa['any_entered']} entered "
            f"tiles of the plain version)")
    for (tab, n), tm in sorted(timings.items()):
        log(f"[kernels] {tab}/{n} rays on {card}: K1 warp {tm['closest_ms']:.4f} ms, per-thread "
            f"{tm['closest_thread_ms']:.4f} (plain {tm['closest_plain_ms']:.4f}); K2 warp "
            f"{tm['any_ms']:.4f} ms, per-thread {tm['any_thread_ms']:.4f} (plain "
            f"{tm['any_plain_ms']:.4f})")
    for (tab, n), tm in sorted(sph_timings.items()):
        log(f"[spheres] {tab}/{n} rays on {card}: K3 closest warp {tm['closest_ms']:.4f} ms, "
            f"per-thread {tm['closest_thread_ms']:.4f} (plain {tm['closest_plain_ms']:.4f}); any "
            f"warp {tm['any_ms']:.4f} ms, per-thread {tm['any_thread_ms']:.4f} (plain "
            f"{tm['any_plain_ms']:.4f})")

    # ---- 8. the traversal-analysis path: K4, the A/B, the roofline, the
    # granularity probe, P
    phases.start("8 probes")
    from curry_pbrt_tpu_torch.ops.kernels import intersect_group as G
    from curry_pbrt_tpu_torch.tools import probe_granularity as PG
    from curry_pbrt_tpu_torch.tools import probe_group_kernel as PK
    from curry_pbrt_tpu_torch.tools import probe_slab_grid as PS
    from curry_pbrt_tpu_torch.tools import roofline as RL
    from curry_pbrt_tpu_torch.tools.workload import Workload

    gsoup_host = G.group_tables(*soup_tris(5000, seed=1), view_origin=np.zeros(3),
                                clusters_per_slab=16)
    gsoup = K.DeviceTables(gsoup_host, dev)
    log(f"[probes] K4 soup tables: {gsoup_host.cluster_aabbs.shape[0]} clusters of "
        f"{gsoup_host.block_t}, {gsoup_host.n_slabs} slabs, supers {gsoup_host.use_supers}, "
        f"{int(np.isnan(gsoup_host.cluster_aabbs[:, 0]).sum())} NaN padding clusters")
    as_t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    check_group("soup5k/32768", gsoup, stab, as_t(gsoup_host.prim), as_t(stab_host.prim),
                make_rays(1 << 15, 60, (0, 0, 0), 9.0, dev), G)

    K.reset_launches()  # the probe path's counts start here
    ab = {}
    for name in ("mesh10k_512", "mesh100k_512"):
        wl = Workload(config_scene(name), dev, tables=mtab if name == "mesh100k_512" else None)
        ab[name] = PK.analyze(name, chunk, PROBE_DEPTH, "cuda", wl=wl, keep=(1, 2))
    ab_launches = dict(K.LAUNCHES)
    for s_ab in ab.values():
        log(f"[probes] K1 (warp walk) / per-thread K1 / K4 A/B on {card}:\n" + PK.report(s_ab))
        PK.check(s_ab)
    log(f"[probes] A/B launches: {ab_launches}")
    if min(ab_launches[k] for k in ("tri_closest_group", "tri_any_group", "tri_closest",
                                    "tri_any", "tri_closest_thread", "tri_any_thread")) <= 0:
        raise AssertionError("the probe path did not launch K4 and both K1 / K2 walks")

    # K4 at mesh10k's bounce 2 against its plain version; its bound from
    # K1's per-ray entered tiles on the same rays (the function's least work)
    s10 = ab["mesh10k_512"]
    pair = s10["pair"]
    o2, d2, tm2, tm2_s = s10["inputs"][2]
    k4_10 = check_group("mesh10k bounce 2", pair.k4, pair.k1, pair.prim4, pair.prim1,
                        (o2, d2, tm2), G, t_any=tm2_s, plain_reps=1)
    k1t = pair.k1
    _, _, ent1, _ = K.tri_closest_hit_tables(o2, d2, tm2, k1t.tris16, k1t.caabb, k1t.saabb,
                                             k1t.slab_aabb, **k1t.kw, stats=True)
    _, any_ent1 = plain["any"](o2, d2, tm2_s, k1t.tris16, k1t.caabb, k1t.saabb, k1t.slab_aabb,
                               **k1t.kw, stats=True)
    ent1, any_ent1 = int(ent1.sum()), int(any_ent1.sum())
    k1_block = k1t.kw["block_t"]
    k4c_b = bound(k4_10["n"], k4_10["live"], 8, k4_10["table_bytes"], ent1, k1_block,
                  TRI_TEST_OPS)
    k4a_b = bound(k4_10["n"], k4_10["any_live"], 1, k4_10["table_bytes"], any_ent1, k1_block,
                  TRI_TEST_OPS)
    r2 = s10["bounces"][2]
    log(f"[bounds] K4 at mesh10k's bounce-2 shape ({k4_10['n']} rays) on {card}: closest "
        f"{r2['k4_ms']:.4f} ms (K1 {r2['k1_ms']:.4f}; plain {k4_10['plain_ms']:.3f}), bound "
        f"{k4c_b[0]:.4f} ms ({k4c_b[1]}; K1's {ent1} entered tiles of {k1_block}; K4's group-"
        f"granular count {k4_10['group_entered']} ray-tiles of {pair.kw4['block_t']} = "
        f"{k4_10['group_entered'] // 8} group tiles); any {r2['k4_any_ms']:.4f} ms (K2 "
        f"{r2['k2_ms']:.4f}; plain {k4_10['any_plain_ms']:.3f}), bound {k4a_b[0]:.4f} ms "
        f"({k4a_b[1]}; K2's {any_ent1} entered tiles; K4's group-granular count "
        f"{k4_10['group_any_entered']})")

    peak = RL.card_peak(dev)
    log(f"[roofline] {card}: peak {peak['derivation']}")
    for name, sc in (("cornell_tex", scene), ("mesh10k_512", config_scene("mesh10k_512"))):
        log(RL.report(RL.analyze(name, chunk, PROBE_DEPTH, "cuda", peak=peak,
                                 wl=Workload(sc, dev))))
    gran = PG.analyze("mesh10k_512", chunk, PROBE_DEPTH, "cuda",
                      wl=Workload(config_scene("mesh10k_512"), dev))
    log(f"[granularity] {card}:\n" + PG.report(gran))

    K.reset_launches()  # P's path: the probe at both shapes
    p_small = PS.run(2, 3, "cuda")
    p_big = PS.run(16384, 7, "cuda")
    p_launches = K.LAUNCHES["slab_grid"]
    if p_launches != 2:
        raise AssertionError(f"the P probe launched its kernel {p_launches} times, not 2")
    p_in = PS.make_inputs(16384, 7, device=dev)
    p_ms = cuda_ms(lambda: PS.slab_grid(*p_in), 20)
    p_plain_ms = cuda_ms(lambda: PS.slab_grid_plain(*p_in), 5)
    p_n, p_s = p_in[1].shape[1], 7
    # row 0 of the rays in, the output out, the slabs and one table entry
    # per slab; 65 operations per slab sum, 2 per (ray, slab)
    p_b = least_ms(p_n * 8 + p_s * (8 * 8 + 1) * 4, p_s * 65 + p_n * p_s * 2)
    log(f"[P] {card}: 2 blocks x 3 slabs max |d| {p_small[1]:.3g} (rel {p_small[2]:.3g}), "
        f"16384 blocks x 7 slabs max |d| {p_big[1]:.3g} (rel {p_big[2]:.3g}) vs plain (rtol "
        f"{PS.RTOL}); {p_ms:.4f} ms (plain {p_plain_ms:.4f}), bound {p_b[0]:.4f} ms ({p_b[1]}); "
        f"launches {p_launches}")

    phases.start()
    # ---- report
    src = "curry_pbrt_tpu_torch/csrc/intersect.cu"
    wsrc = "curry_pbrt_tpu_torch/csrc/intersect_warp.cu"
    field_l = config_runs["spherefield10k_256"]["launches"]
    m100_l = config_runs["mesh100k_512"]["launches"]

    def entry(name, replaces, launches, err, ms, plain_ms, b, source=src):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b[0], "bound_by": b[1], "library_ms": None}

    tri_k = "curry_pbrt_tpu/ops/pallas/intersect_kernel.py"
    sph_k = "curry_pbrt_tpu/ops/pallas/sphere_kernel.py"
    grp_k = "curry_pbrt_tpu/ops/pallas/intersect_group.py"
    grp_src = "curry_pbrt_tpu_torch/csrc/intersect_group.cu"
    # K1 / K2: the warp walk at mesh100k's bounce-2 shapes (its render path:
    # launches per pass), the per-thread walk at the headline shape (its
    # path, by the plan's rule for 8-row clusters)
    kernels = [
        entry("tri_closest_hit", f"{tri_k}:709", m100_l["tri_closest"], st100["max_abs_err"],
              st100["ms"], st100["plain_ms"], k1_100_b, wsrc),
        entry("tri_any_hit", f"{tri_k}:760", m100_l["tri_any"], any100["max_abs_err"],
              any100["ms"], any100["plain_ms"], k2_100_b, wsrc),
        entry("tri_closest_hit_stats", f"{tri_k}:712", stats_launches,
              st100["stats_max_abs_err"], st100["stats_ms"], st100["stats_plain_ms"], k1s_b, wsrc),
        entry("tri_closest_hit_thread", f"{tri_k}:709", head_launches["tri_closest_thread"],
              head_shape["thread_max_abs_err"], head_shape["closest_thread_ms"],
              head_shape["closest_plain_ms"], k1_b),
        entry("tri_any_hit_thread", f"{tri_k}:760", head_launches["tri_any_thread"],
              head_shape["any_thread_max_abs_err"], head_shape["any_thread_ms"],
              head_shape["any_plain_ms"], k2_b),
        entry("tri_closest_hit_stats_thread", f"{tri_k}:712", stats_thread_launches,
              st100["stats_thread_max_abs_err"], st100["stats_thread_ms"],
              st100["stats_plain_ms"], k1s_b),
        # K3: both walks at the sphere field's bounce-1 shapes; the warp
        # walk's launches per pass, the per-thread walk's in phase 7's A/B
        entry("sphere_closest_hit", f"{sph_k}:216", field_l["sphere_closest"],
              f_cl["max_abs_err"], f_cl["closest_ms"], f_cl["closest_plain_ms"], k3c_b, wsrc),
        entry("sphere_any_hit", f"{sph_k}:256", field_l["sphere_any"], f_any["any_max_abs_err"],
              f_any["any_ms"], f_any["any_plain_ms"], k3a_b, wsrc),
        entry("sphere_closest_hit_thread", f"{sph_k}:216", k3_thread_launches[0],
              f_cl["thread_max_abs_err"], f_cl["closest_thread_ms"], f_cl["closest_plain_ms"],
              k3c_b),
        entry("sphere_any_hit_thread", f"{sph_k}:256", k3_thread_launches[1],
              f_any["any_thread_max_abs_err"], f_any["any_thread_ms"], f_any["any_plain_ms"],
              k3a_b),
        entry("tri_closest_hit_groups", f"{grp_k}:345", ab_launches["tri_closest_group"],
              k4_10["max_abs_err"], r2["k4_ms"], k4_10["plain_ms"], k4c_b, grp_src),
        entry("tri_any_hit_groups", f"{grp_k}:382", ab_launches["tri_any_group"],
              k4_10["any_max_abs_err"], r2["k4_any_ms"], k4_10["any_plain_ms"], k4a_b, grp_src),
        entry("slab_grid_probe", "tools/probe_slab_grid.py:34", p_launches, p_big[1], p_ms,
              p_plain_ms, p_b, "curry_pbrt_tpu_torch/csrc/slab_grid.cu"),
    ]
    log(f"[total] chip_smoke ran {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
