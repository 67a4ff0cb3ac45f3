"""Closest-hit (K1) and any-hit (K2) triangle traversal over cluster tables:
the host table construction, the wrappers of the CUDA kernels in
csrc/intersect_small.cu and csrc/intersect_warp.cu, their launch plan, and
their plain PyTorch versions.

Counterpart of the JAX package's ops/pallas/intersect_kernel.py. The host
table functions are copied as they are, so both packages build identical tables:

  triangles are sorted into blocked kd-median cells (or Morton runs), each
  block_t rows forming a "cluster" with an AABB; SUPER_G consecutive
  clusters form a super-cluster with its own AABB (use_supers, beyond
  USE_SUPERS_MIN clusters); clusters are grouped into slabs of
  clusters_per_slab, each with an AABB; clusters and supers are ordered
  front-to-back from the camera. Empty boxes are NaN, so they are never
  entered.

`tri_closest_hit_tables` / `tri_any_hit_tables` take the ray batch and the
tables. For tensors on the CPU they run the plain versions; for CUDA tensors
they launch the kernel `launch_plan` picks from block_t, and
raise if it cannot run — there is no fallback from the card to the plain
code: for tables of at most SMALL_MAX_BLOCK_T rows a cluster (the
small-scene plan's tables: the Cornell scenes) the small-table walk of
csrc/intersect_small.cu (the table in shared memory, one thread per live
ray, the live rays binned by dominant axis), which refuses tables it cannot
stage (more than one slab, supers, more than SMALL_TABLE_MAX_BYTES);
beyond, the warp-cooperative walk of csrc/intersect_warp.cu (the 32 lanes
of a warp on one ray, lanes on a cluster's rows, live rays only).
`tri_closest_hit_small` / `tri_closest_hit_warp` (and the any-hit pair)
force one walk, for the A/B of chip_smoke.py and the tools.
`LAUNCHES` counts kernel launches per kernel, those of the sphere kernels
(sphere_kernel.py), the group kernels (intersect_group.py), the BVH walk
(bvh_kernel.py), the slab-grid probe (tools/probe_slab_grid.py), the
texel gather's backward (texel_grad.py), next-event estimation (nee.py)
and the path continuation (shade.py) included.

`stats=True` (K1b, the JAX kernel's roofline instrumentation) also returns
per-ray (entered, improved) int32 counts: the cluster tiles each ray
entered, and those that improved its best t. The JAX kernel counts per
128/256-lane sub-group; the port counts per ray. The plain versions count
the same (the any-hit one only entered tiles); no render path asks for
them — they feed the bounds in PERF.md.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX, Float, gamma
from curry_pbrt_tpu_torch.ops.intersect import ray_shear, watertight_core

_G2 = Float(gamma(2))
_G3 = Float(gamma(3))
_G5 = Float(gamma(5))
T_SCALE = Float(1.0 + 2.0 * gamma(3))  # conservative slab widening (bounds.rs:303-323)

TRI_COLS = 16
BLOCK_T = 64  # default tris/cluster; small scenes pass block_t=8
SUPER_G = 8  # clusters per super-cluster (level-1 fan-out)
SLAB_CLUSTERS = 256  # clusters per slab
USE_SUPERS_MIN = 96  # enable the super-cluster level beyond this many clusters

# Kernel launches per wrapper since the last reset (plain-version calls on
# CPU tensors are not launches and are not counted). tri_* / sphere_*: the
# warp walk; tri_*_small: the small-table walk; tri_*_group: the group
# kernel K4; bvh_*: the live-ray BVH walk; texel_grad: a texel gather's
# backward (its sort and segment-sum launches); nee_sample / nee_finish:
# the two halves of next-event estimation (nee.py), one each a call;
# shade_continue: the path continuation (shade.py), one a call.
LAUNCHES = {"tri_closest": 0, "tri_closest_stats": 0, "tri_any": 0,
            "tri_closest_small": 0, "tri_closest_stats_small": 0, "tri_any_small": 0,
            "sphere_closest": 0, "sphere_any": 0,
            "tri_closest_group": 0, "tri_any_group": 0, "slab_grid": 0,
            "bvh_closest": 0, "bvh_any": 0,
            "texel_grad": 0, "nee_sample": 0, "nee_finish": 0, "shade_continue": 0}

WARP = 32
# Triangle tables of up to this many rows a cluster take the small-table
# walk: over the K1 / K2 calls of a headline pass it measured 0.51x / 0.42x
# the time of a walk of one thread per ray (retired since), where the warp
# walk, 24 of its 32 lanes idle on 8-row clusters, measured 3.4x / 2.2x it
# (chip_smoke.py phases 3 and 7, PERF.md).
SMALL_MAX_BLOCK_T = 8
# What the small-table walk stages in shared memory: 48 bytes a row (its 10
# used columns, 16-byte aligned) and 32 a cluster box, at most this many
# bytes (csrc/intersect_small.cu MAX_TABLE_BYTES) — 98 clusters of 8 rows.
SMALL_ROW_BYTES, SMALL_BOX_BYTES = 48, 32
SMALL_TABLE_MAX_BYTES = 40 * 1024
WALK_SUFFIX = {"warp": "", "small": "_small"}  # LAUNCHES keys


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m



def block_aabbs(p0, p1, p2, valid, block_t: int = BLOCK_T) -> np.ndarray:
    """Host-side per-block_t cluster AABBs → (T_pad/block_t, 8) f32.

    Invalid/padding rows are excluded; an all-invalid block gets a NaN box."""
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    p2 = np.asarray(p2, np.float32)
    valid = np.asarray(valid, bool)
    t = p0.shape[0]
    t_pad = _round_up(max(t, 1), block_t)
    nb = t_pad // block_t
    pad = t_pad - t
    if pad:
        z = np.full((pad, 3), np.nan, np.float32)
        p0, p1, p2 = (np.concatenate([a, z]) for a in (p0, p1, p2))
        valid = np.concatenate([valid, np.zeros((pad,), bool)])
    tmin = np.minimum(np.minimum(p0, p1), p2)
    tmax = np.maximum(np.maximum(p0, p1), p2)
    nanv = np.where(valid[:, None], 0.0, np.nan).astype(np.float32)
    out = np.zeros((nb, 8), np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN slices
        out[:, 0:3] = np.nanmin((tmin + nanv).reshape(nb, block_t, 3), axis=1)
        out[:, 3:6] = np.nanmax((tmax + nanv).reshape(nb, block_t, 3), axis=1)
    return out


def union_boxes(boxes: np.ndarray) -> np.ndarray:
    """(..., k, 8) NaN-aware AABB union → (..., 8); all-NaN → NaN box."""
    out = np.zeros(boxes.shape[:-2] + (8,), np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        out[..., 0:3] = np.nanmin(boxes[..., 0:3], axis=-2)
        out[..., 3:6] = np.nanmax(boxes[..., 3:6], axis=-2)
    return out


def kdmedian_order(p0, p1, p2, block_t: int) -> np.ndarray:
    """Host-side blocked kd-median permutation: recursively split the
    triangle set on the widest centroid axis at the nearest multiple of
    block_t to the median, so every contiguous block_t run is one kd cell.

    Cells are compact axis-aligned regions — markedly tighter cluster AABBs
    than same-size Morton runs (a Z-curve block can straddle curve jumps),
    measured ~25-40% fewer entered tiles on the mesh scenes
    (tools/probe_granularity.py --cluster-mode). Exact block_t fills keep
    the tile math fully utilized (an SAH-treelet cut would leave padding
    rows). Deterministic (stable sorts)."""
    c = ((np.asarray(p0, np.float64) + np.asarray(p1) + np.asarray(p2)) / 3.0)
    n = c.shape[0]
    order = np.arange(n)
    stack = [(0, n)]
    while stack:
        lo, hi = stack.pop()
        count = hi - lo
        if count <= block_t:
            continue
        idx = order[lo:hi]
        ext = c[idx].max(axis=0) - c[idx].min(axis=0)
        axis = int(np.argmax(ext))
        order[lo:hi] = idx[np.argsort(c[idx, axis], kind="stable")]
        half = count // 2
        k = int(np.clip(round(half / block_t) * block_t, block_t,
                        ((count - 1) // block_t) * block_t))
        stack.append((lo, lo + k))
        stack.append((lo + k, hi))
    return order.astype(np.int32)


def morton_order(p0, p1, p2) -> np.ndarray:
    """Host-side Morton (Z-curve) permutation of triangle centroids so
    contiguous BLOCK_T blocks are spatially tight clusters."""
    c = (np.asarray(p0, np.float64) + np.asarray(p1) + np.asarray(p2)) / 3.0
    lo, hi = c.min(axis=0), c.max(axis=0)
    ext = np.where(hi - lo > 0, hi - lo, 1.0)
    q = np.clip(((c - lo) / ext * 1023.0).astype(np.uint64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    key = (spread(q[:, 0]) << np.uint64(2)) | (spread(q[:, 1]) << np.uint64(1)) | spread(q[:, 2])
    return np.argsort(key, kind="stable").astype(np.int32)


@dataclasses.dataclass
class TriTables:
    """Host-built (numpy) kernel tables: Morton-ordered, front-to-back
    super/cluster permuted, padded to whole slabs."""

    p0: np.ndarray  # (T_pad, 3) final kernel row order
    p1: np.ndarray
    p2: np.ndarray
    prim: np.ndarray  # (T_pad,) i32, -1 = padding
    valid: np.ndarray  # (T_pad,) bool
    tris16: np.ndarray  # (T_pad, 16) packed kernel layout
    cluster_aabbs: np.ndarray  # (C, 8)
    super_aabbs: np.ndarray  # (C // SUPER_G, 8)
    slab_aabbs: np.ndarray  # (n_slabs, 8)
    block_t: int
    clusters_per_slab: int
    use_supers: bool

    @property
    def n_slabs(self) -> int:
        return self.slab_aabbs.shape[0]


def pack_tris_np(p0, p1, p2, valid) -> np.ndarray:
    t = p0.shape[0]
    out = np.zeros((t, TRI_COLS), np.float32)
    out[:, 0:3] = p0
    out[:, 3:6] = p1
    out[:, 6:9] = p2
    out[:, 9] = np.where(valid, 1.0, -1.0)
    return out


def build_tri_tables(
    p0, p1, p2, prim,
    block_t: int = BLOCK_T,
    view_origin=None,
    clusters_per_slab: int = SLAB_CLUSTERS,
    use_supers=None,
    cluster_mode: str = "kdmedian",
) -> TriTables:
    """Spatially sort triangles (cluster_mode: "kdmedian" blocked kd cells,
    the default — or "morton" Z-curve runs), group block_t rows into
    clusters and SUPER_G clusters into supers, order supers (and clusters
    within supers) front-to-back from view_origin, pad to whole slabs, and
    precompute every AABB level + the packed (T,16) table. Deterministic."""
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    p2 = np.asarray(p2, np.float32)
    prim = np.asarray(prim, np.int32)

    if cluster_mode == "kdmedian":
        order = kdmedian_order(p0, p1, p2, block_t)
    elif cluster_mode == "morton":
        order = morton_order(p0, p1, p2)
    else:
        raise ValueError(f"unknown cluster_mode {cluster_mode!r}")
    p0, p1, p2, prim = p0[order], p1[order], p2[order], prim[order]

    t = p0.shape[0]
    nc_raw = -(-max(t, 1) // block_t)
    if use_supers is None:
        use_supers = nc_raw > USE_SUPERS_MIN
    use_supers = bool(use_supers)
    if use_supers or nc_raw > clusters_per_slab:
        # super grouping / multi-slab blocking need SUPER_G alignment
        nc = _round_up(nc_raw, SUPER_G)
        cps = int(min(clusters_per_slab, nc))
        if cps % SUPER_G:
            raise ValueError(f"clusters_per_slab must be a multiple of {SUPER_G}")
        n_slabs = -(-nc // cps)
        nc = n_slabs * cps
    else:
        # tiny scene: exact cluster count — padding clusters would lengthen
        # every sweep
        nc, cps, n_slabs = nc_raw, nc_raw, 1
    t_pad = nc * block_t
    if t_pad > t:
        z = np.zeros((t_pad - t, 3), np.float32)
        p0, p1, p2 = (np.concatenate([a, z]) for a in (p0, p1, p2))
        prim = np.concatenate([prim, np.full((t_pad - t,), -1, np.int32)])
    valid = prim >= 0

    caabb = block_aabbs(p0, p1, p2, valid, block_t)
    ns = nc // SUPER_G

    if view_origin is not None:
        vo = np.asarray(view_origin, np.float64)
        ccent = (caabb[:, 0:3].astype(np.float64) + caabb[:, 3:6]) * 0.5
        cdist = np.linalg.norm(ccent - vo, axis=-1)
        cdist = np.where(np.isnan(cdist), np.inf, cdist)  # padding → last
        if nc % SUPER_G == 0:
            # order supers front-to-back, then clusters within each super
            sdist = cdist.reshape(ns, SUPER_G).min(axis=1)
            sorder = np.argsort(sdist, kind="stable")
            within = np.argsort(cdist.reshape(ns, SUPER_G), axis=1, kind="stable")
            cluster_order = (
                sorder[:, None] * SUPER_G + within[sorder]
            ).reshape(-1)
        else:
            cluster_order = np.argsort(cdist, kind="stable")
        row_order = (
            cluster_order[:, None] * block_t + np.arange(block_t)[None, :]
        ).reshape(-1)
        p0, p1, p2 = p0[row_order], p1[row_order], p2[row_order]
        prim, valid = prim[row_order], valid[row_order]
        caabb = caabb[cluster_order]

    use_supers = use_supers and cps > SUPER_G
    if use_supers:
        saabb = union_boxes(caabb.reshape(ns, SUPER_G, 8))
    else:  # unread by the kernel; keep a valid (1, 8) placeholder
        saabb = union_boxes(caabb[None, :, :])
    slab_aabb = union_boxes(caabb.reshape(n_slabs, cps, 8))

    return TriTables(
        p0=p0, p1=p1, p2=p2, prim=prim, valid=valid,
        tris16=pack_tris_np(p0, p1, p2, valid),
        cluster_aabbs=caabb, super_aabbs=saabb, slab_aabbs=slab_aabb,
        block_t=block_t, clusters_per_slab=cps, use_supers=use_supers,
    )

# ---------------------------------------------------------------------------
# plain PyTorch versions — the same walk, vectorized over rays


def _box_enter(box, o, inv_d, t_best):
    """Widened slab test of rays (o, inv_d: (N,3)) against one AABB row
    (box: (8,) tensor) → (N,) bool. torch.minimum/maximum propagate NaN, so
    an empty cluster's NaN box is never entered; `t_best > 0` is the
    dead-lane gate (integrators pass t_max = 0 for discarded lanes)."""
    t0 = (box[0:3] - o) * inv_d
    t1 = (box[3:6] - o) * inv_d
    near = torch.minimum(t0, t1)
    far = torch.maximum(t0, t1) * float(T_SCALE)
    tn = torch.maximum(near[:, 0], torch.maximum(near[:, 1], near[:, 2]))
    tf = torch.minimum(far[:, 0], torch.minimum(far[:, 1], far[:, 2]))
    return (tn <= tf) & (tn < t_best) & (tf > 0.0) & (t_best > 0.0)


def _box_near(box, o, inv_d):
    """_box_enter split at the bound (csrc/intersect.cuh box_near): each
    ray's entry distance tn into the box, NaN where the box is never entered
    whatever the bound, so that _box_enter(box, o, inv_d, b) ==
    (_box_near(box, o, inv_d) < b) & (b > 0)."""
    t0 = (box[0:3] - o) * inv_d
    t1 = (box[3:6] - o) * inv_d
    near = torch.minimum(t0, t1)
    far = torch.maximum(t0, t1) * float(T_SCALE)
    tn = torch.maximum(near[:, 0], torch.maximum(near[:, 1], near[:, 2]))
    tf = torch.minimum(far[:, 0], torch.minimum(far[:, 1], far[:, 2]))
    return torch.where((tn <= tf) & (tf > 0.0), tn, float("nan"))


def _tile_test(rows, o, kz, sx, sy, sz, t_best):
    """Watertight test of rays (N,·) against table rows (B,16) → (N,B) t,
    FLOAT_MAX where there is no hit (padding rows never hit)."""
    t, _b, ok = watertight_core(
        o[:, None, :], kz[:, None], sx[:, None], sy[:, None], sz[:, None],
        t_best[:, None], rows[None, :, 0:3], rows[None, :, 3:6], rows[None, :, 6:9],
        with_bary=False,
    )
    ok = ok & (rows[None, :, 9] > 0.0)
    return torch.where(ok, t, float(FLOAT_MAX))


def _per_ray(mask):
    return mask


def _walk(saabb, slab_aabb, cps, use_supers, o, d, t_bound, visit, spread=_per_ray):
    """Front-to-back walk shared by every plain version: for every cluster,
    in table order, call visit(c, gate, inv_d) with the (N,) mask of rays
    whose slab and super tests passed. The box tests use t_bound(), each
    ray's current bound at the time of the test; spread(mask) turns each
    level's per-ray result into the rays that test on (per ray for K1-K3;
    the whole group of 8 for the group kernel K4)."""
    inv_d = 1.0 / torch.where(d == 0, float(Float(1e-30)), d)
    n_slabs = slab_aabb.shape[0]
    all_rays = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    for j in range(n_slabs):
        slab_gate = all_rays
        if n_slabs > 1:
            slab_gate = spread(_box_enter(slab_aabb[j], o, inv_d, t_bound()))
        if use_supers:
            for s in range(cps // SUPER_G):
                gate = slab_gate & spread(
                    _box_enter(saabb[j * (cps // SUPER_G) + s], o, inv_d, t_bound()))
                for c_off in range(SUPER_G):
                    visit(j * cps + s * SUPER_G + c_off, gate, inv_d)
        else:
            for c in range(cps):
                visit(j * cps + c, slab_gate, inv_d)


def _closest_plain(tile, o, d, t_max, prims, caabb, saabb, slab_aabb, block, cps, use_supers,
                   stats, spread=_per_ray, narrow=None):
    """The closest-hit walk of every plain version: per cluster, the rays
    that enter its box test all `block` rows against their best t frozen at
    the cluster's start — tile(rows, ids, t_best) → (len(ids), block) t,
    FLOAT_MAX where there is no hit; the tile's smallest t (lowest row on a
    tie) is accepted on strict improvement, or at exactly t_max for a ray's
    first hit. Returns (t, row) and, with stats, per-ray (entered, improved)
    int32 counts of the tiles each ray entered and of those that improved
    its best t. spread: see _walk (with the group spread, a ray counts
    every tile its group tested). narrow(c, inv_d, bound) → (N,) mask, where
    given, keeps of the rays spread lets into cluster c those that test its
    rows (the group kernel's per-ray gate); entered then counts those
    tiles."""
    t_best = t_max.clone()
    idx = torch.full(t_max.shape, -1, dtype=torch.int32, device=o.device)
    entered = torch.zeros(t_max.shape, dtype=torch.int32, device=o.device)
    improved = torch.zeros_like(entered)
    fmax = float(FLOAT_MAX)

    def visit(c, gate, inv_d):
        enter = gate & spread(_box_enter(caabb[c], o, inv_d, t_best))
        if narrow is not None:
            enter = enter & narrow(c, inv_d, t_best)
        ids = torch.nonzero(enter).squeeze(1)
        if ids.numel() == 0:
            return
        tb = t_best[ids]
        t = tile(prims[c * block:(c + 1) * block], ids, tb)
        t_min, row = torch.min(t, dim=1)  # first index of the minimum
        cur = idx[ids]
        better = (t_min < tb) | ((t_min == tb) & (cur < 0) & (t_min < fmax))
        t_best[ids] = torch.where(better, t_min, tb)
        idx[ids] = torch.where(better, (c * block + row).to(torch.int32), cur)
        if stats:
            entered[ids] += 1
            improved[ids] += better.to(torch.int32)

    _walk(saabb, slab_aabb, cps, use_supers, o, d, lambda: t_best, visit, spread)
    out = (torch.where(idx >= 0, t_best, fmax), idx)
    return out + (entered, improved) if stats else out


def _any_plain(tile, o, d, t_max, prims, caabb, saabb, slab_aabb, block, cps, use_supers, stats,
               spread=_per_ray, narrow=None):
    """The any-hit walk of every plain version: a ray stops at its first
    cluster with any row hit within t_max. Returns (N,) bool and, with
    stats, the per-ray int32 count of tiles entered (spread: see _walk;
    narrow: see _closest_plain, called with each ray's bound, 0 once it
    has hit)."""
    hit = torch.zeros(t_max.shape, dtype=torch.bool, device=o.device)
    entered = torch.zeros(t_max.shape, dtype=torch.int32, device=o.device)
    # rays already hit carry bound 0, which fails every later box test
    bound = lambda: torch.where(hit, 0.0, t_max)  # noqa: E731

    def visit(c, gate, inv_d):
        enter = gate & spread(~hit & _box_enter(caabb[c], o, inv_d, t_max))
        if narrow is not None:
            enter = enter & narrow(c, inv_d, bound())
        ids = torch.nonzero(enter).squeeze(1)
        if ids.numel() == 0:
            return
        t = tile(prims[c * block:(c + 1) * block], ids, t_max[ids])
        hit[ids] = hit[ids] | torch.any(t < float(FLOAT_MAX), dim=1)
        if stats:
            entered[ids] += 1

    _walk(saabb, slab_aabb, cps, use_supers, o, d, bound, visit, spread)
    return (hit, entered) if stats else hit


def _tri_tile(o, d):
    kz, sx, sy, sz = ray_shear(d)
    return lambda rows, ids, tb: _tile_test(rows, o[ids], kz[ids], sx[ids], sy[ids], sz[ids], tb)


def tri_closest_hit_plain(o, d, t_max, tris16, caabb, saabb, slab_aabb, *,
                          block_t: int, clusters_per_slab: int, use_supers: bool,
                          stats: bool = False):
    """Plain version of the closest-hit kernel (the walk of _closest_plain
    with the watertight triangle test). Returns (t (N,) f32, FLOAT_MAX on
    miss; row (N,) int32, -1 on miss), plus (entered, improved) with stats."""
    return _closest_plain(_tri_tile(o, d), o, d, t_max, tris16, caabb, saabb, slab_aabb,
                          block_t, clusters_per_slab, use_supers, stats)


def tri_any_hit_plain(o, d, t_max, tris16, caabb, saabb, slab_aabb, *,
                      block_t: int, clusters_per_slab: int, use_supers: bool,
                      stats: bool = False):
    """Plain version of the any-hit kernel. Returns (N,) bool, plus the
    per-ray count of entered tiles with stats (the kernel has no stats)."""
    return _any_plain(_tri_tile(o, d), o, d, t_max, tris16, caabb, saabb, slab_aabb,
                      block_t, clusters_per_slab, use_supers, stats)


# ---------------------------------------------------------------------------
# wrappers


def _check(o, d, t_max, prims, caabb, saabb, slab_aabb, block, cps, use_supers):
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3) or t_max.shape != (n,):
        raise ValueError(f"rays must be o, d (N,3) and t_max (N,); got {o.shape}, {d.shape}, {t_max.shape}")
    tensors = (o, d, t_max, prims, caabb, saabb, slab_aabb)
    if any(x.dtype != torch.float32 for x in tensors):
        raise TypeError("traversal inputs must be float32")
    if any(x.device != o.device for x in tensors):
        raise ValueError("rays and tables must be on one device")
    if block < 1:
        raise ValueError(f"block_t must be at least 1, got {block}")
    nc = caabb.shape[0]
    if caabb.shape != (nc, 8) or nc % cps or slab_aabb.shape != (nc // cps, 8):
        raise ValueError(f"table shapes disagree: caabb {tuple(caabb.shape)}, "
                         f"slab {tuple(slab_aabb.shape)}, clusters_per_slab {cps}")
    if prims.shape != (nc * block, TRI_COLS):
        raise ValueError(f"primitive table must be ({nc * block}, {TRI_COLS}), got {tuple(prims.shape)}")
    if use_supers and (cps % SUPER_G or saabb.shape[0] < nc // SUPER_G):
        raise ValueError("use_supers needs clusters_per_slab % SUPER_G == 0 and one super box per SUPER_G clusters")
    if o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no traversal kernel for device {o.device}")


def launch_plan(block_t: int, spheres: bool = False) -> str:
    """The walk tri_closest_hit_tables / tri_any_hit_tables (and, with
    spheres, the sphere wrappers, from block_s) launch for tables of block_t
    rows a cluster: "small" (csrc/intersect_small.cu) for triangle tables of
    up to SMALL_MAX_BLOCK_T rows, else "warp" (csrc/intersect_warp.cu), the
    one walk with a sphere test."""
    return "small" if block_t <= SMALL_MAX_BLOCK_T and not spheres else "warp"


def small_table_bytes(n_clusters: int, block_t: int) -> int:
    """Shared memory the small-table walk stages for a table."""
    return n_clusters * (block_t * SMALL_ROW_BYTES + SMALL_BOX_BYTES)


def _choose_walk(walk, o, caabb, slab_aabb, block, use_supers) -> str:
    """The walk a launch takes: `walk` where one is forced, else the plan's.
    Raises for tables the small-table walk cannot stage where it would take
    them: a forced small walk on every device, the plan's on the card."""
    chosen = walk or launch_plan(block)
    if chosen == "small" and (walk or o.device.type != "cpu"):
        _check_small(caabb, slab_aabb, block, use_supers)
    return chosen


def _check_small(caabb, slab_aabb, block, use_supers):
    """Raise for tables the small-table walk does not take."""
    nc = caabb.shape[0]
    if block > SMALL_MAX_BLOCK_T or slab_aabb.shape[0] != 1 or use_supers:
        raise ValueError(f"the small-table walk takes one slab, no supers and at most "
                         f"{SMALL_MAX_BLOCK_T} rows a cluster; got {slab_aabb.shape[0]} "
                         f"slabs, supers {bool(use_supers)}, block_t {block}")
    if small_table_bytes(nc, block) > SMALL_TABLE_MAX_BYTES:
        raise ValueError(f"the small-table walk stages at most {SMALL_TABLE_MAX_BYTES} bytes of "
                         f"table in shared memory; {nc} clusters of {block} rows need "
                         f"{small_table_bytes(nc, block)}")


def _aligned(x):
    """x contiguous and 16-byte aligned (the kernels read rows and boxes as
    16-byte vectors): a misaligned view is copied."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def launch_entry(lib, entry: str, outs, o, d, t_max, prims, caabb, saabb, slab_aabb, block, cps,
                 use_supers) -> bool:
    """Launch one table-walk entry point of `lib` (the CURRY_TABLE_ARGS of
    csrc/intersect.cuh) on CUDA tensors: the C arguments are the contiguous
    inputs, the table sizes, the error-bound constants, the output pointers
    (None → NULL) and the current stream. Raises on a refused launch;
    returns whether it launched (no ray, no launch)."""
    if o.shape[0] == 0:
        return False
    if o.shape[0] > 2**31 - 1 - WARP:
        raise ValueError(f"the kernels index rays with 32-bit ints; got {o.shape[0]} rays")
    keep = [_aligned(x) for x in (o, d, t_max, prims, caabb, saabb, slab_aabb)]
    args = [x.data_ptr() for x in keep]
    args += [o.shape[0], block, cps, slab_aabb.shape[0], int(bool(use_supers))]
    args += [float(_G2), float(_G3), float(_G5), float(T_SCALE)]
    args += [None if x is None else x.data_ptr() for x in outs]
    err = getattr(lib, entry)(*args, torch.cuda.current_stream(o.device).cuda_stream)
    # `keep` may be freed now: the caching allocator reuses its memory only
    # for work queued after this launch on the same stream
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    return True


def _launch(entry: str, counter: str, outs, *args):
    """launch_entry on the port's library (csrc/*.cu); counts the launch."""
    from curry_pbrt_tpu_torch.ops.kernels.build import load_library

    if launch_entry(load_library(), entry, outs, *args):
        LAUNCHES[counter] += 1


def _closest_outputs(o, stats: bool):
    """Uninitialised (t, row[, entered, improved]) outputs for N rays."""
    n, dev = o.shape[0], o.device
    outs = [torch.empty((n,), dtype=torch.float32, device=dev),
            torch.empty((n,), dtype=torch.int32, device=dev)]
    if stats:
        outs += [torch.empty((n,), dtype=torch.int32, device=dev) for _ in range(2)]
    return outs


def _closest(walk, o, d, t_max, tris16, caabb, saabb, slab_aabb, block_t, clusters_per_slab,
             use_supers, stats):
    args = (o, d, t_max, tris16, caabb, saabb, slab_aabb)
    _check(*args, block_t, clusters_per_slab, use_supers)
    walk = _choose_walk(walk, o, caabb, slab_aabb, block_t, use_supers)
    if o.device.type == "cpu":
        return tri_closest_hit_plain(*args, block_t=block_t, clusters_per_slab=clusters_per_slab,
                                     use_supers=use_supers, stats=stats)
    outs = _closest_outputs(o, stats)
    counter = ("tri_closest_stats" if stats else "tri_closest") + WALK_SUFFIX[walk]
    _launch("curry_tri_closest_hit_" + walk, counter, outs if stats else outs + [None, None],
            *args, block_t, clusters_per_slab, use_supers)
    return tuple(outs)


def _any(walk, o, d, t_max, tris16, caabb, saabb, slab_aabb, block_t, clusters_per_slab,
         use_supers):
    args = (o, d, t_max, tris16, caabb, saabb, slab_aabb)
    _check(*args, block_t, clusters_per_slab, use_supers)
    walk = _choose_walk(walk, o, caabb, slab_aabb, block_t, use_supers)
    if o.device.type == "cpu":
        return tri_any_hit_plain(*args, block_t=block_t, clusters_per_slab=clusters_per_slab,
                                 use_supers=use_supers)
    hit = torch.empty((o.shape[0],), dtype=torch.bool, device=o.device)
    _launch("curry_tri_any_hit_" + walk, "tri_any" + WALK_SUFFIX[walk], [hit], *args, block_t,
            clusters_per_slab, use_supers)
    return hit


def tri_closest_hit_tables(o, d, t_max, tris16, caabb, saabb, slab_aabb, *,
                           block_t: int, clusters_per_slab: int, use_supers: bool,
                           stats: bool = False):
    """Closest hit over TriTables tensors. o/d: (N,3), t_max: (N,) float32.
    Returns (t: (N,) f32, FLOAT_MAX on miss; row: (N,) int32 table row, -1
    on miss); with stats=True also per-ray (entered, improved) int32 tile
    counts (the TPU kernel counts per lane sub-group; the port per ray).
    CPU tensors → plain version; CUDA tensors → the kernel launch_plan
    picks from block_t (the warp walk, or the small-table walk for
    block_t <= SMALL_MAX_BLOCK_T)."""
    return _closest(None, o, d, t_max, tris16, caabb, saabb, slab_aabb, block_t,
                    clusters_per_slab, use_supers, stats)


def tri_any_hit_tables(o, d, t_max, tris16, caabb, saabb, slab_aabb, *,
                       block_t: int, clusters_per_slab: int, use_supers: bool):
    """Any-hit (shadow) test over TriTables tensors → (N,) bool. CPU tensors
    → plain version; CUDA tensors → the kernel launch_plan picks."""
    return _any(None, o, d, t_max, tris16, caabb, saabb, slab_aabb, block_t, clusters_per_slab,
                use_supers)


def tri_closest_hit_small(o, d, t_max, tris16, caabb, saabb, slab_aabb, *,
                          block_t: int, clusters_per_slab: int, use_supers: bool,
                          stats: bool = False):
    """tri_closest_hit_tables through the small-table walk
    (csrc/intersect_small.cu) whatever the plan; raises, on every device,
    for tables it does not take (_check_small)."""
    return _closest("small", o, d, t_max, tris16, caabb, saabb, slab_aabb, block_t,
                    clusters_per_slab, use_supers, stats)


def tri_any_hit_small(o, d, t_max, tris16, caabb, saabb, slab_aabb, *,
                      block_t: int, clusters_per_slab: int, use_supers: bool):
    """tri_any_hit_tables through the small-table walk whatever the plan."""
    return _any("small", o, d, t_max, tris16, caabb, saabb, slab_aabb, block_t,
                clusters_per_slab, use_supers)


def tri_closest_hit_warp(o, d, t_max, tris16, caabb, saabb, slab_aabb, *,
                         block_t: int, clusters_per_slab: int, use_supers: bool,
                         stats: bool = False):
    """tri_closest_hit_tables through the warp walk whatever the plan: the
    A/B at block_t <= 8."""
    return _closest("warp", o, d, t_max, tris16, caabb, saabb, slab_aabb, block_t,
                    clusters_per_slab, use_supers, stats)


def tri_any_hit_warp(o, d, t_max, tris16, caabb, saabb, slab_aabb, *,
                     block_t: int, clusters_per_slab: int, use_supers: bool):
    """tri_any_hit_tables through the warp walk whatever the plan."""
    return _any("warp", o, d, t_max, tris16, caabb, saabb, slab_aabb, block_t,
                clusters_per_slab, use_supers)


class DeviceTables:
    """TriTables arrays as tensors on one device, with the kernel keywords."""

    def __init__(self, tables: TriTables, device):
        as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
        self.tris16 = as_t(tables.tris16)
        self.caabb = as_t(tables.cluster_aabbs)
        self.saabb = as_t(tables.super_aabbs)
        self.slab_aabb = as_t(tables.slab_aabbs)
        self.kw = dict(block_t=tables.block_t, clusters_per_slab=tables.clusters_per_slab,
                       use_supers=tables.use_supers)

    def closest(self, o, d, t_max):
        return tri_closest_hit_tables(o, d, t_max, self.tris16, self.caabb, self.saabb,
                                      self.slab_aabb, **self.kw)

    def any_hit(self, o, d, t_max):
        return tri_any_hit_tables(o, d, t_max, self.tris16, self.caabb, self.saabb,
                                  self.slab_aabb, **self.kw)

    def closest_small(self, o, d, t_max):
        return tri_closest_hit_small(o, d, t_max, self.tris16, self.caabb, self.saabb,
                                     self.slab_aabb, **self.kw)

    def any_hit_small(self, o, d, t_max):
        return tri_any_hit_small(o, d, t_max, self.tris16, self.caabb, self.saabb,
                                 self.slab_aabb, **self.kw)

    def closest_warp(self, o, d, t_max):
        return tri_closest_hit_warp(o, d, t_max, self.tris16, self.caabb, self.saabb,
                                    self.slab_aabb, **self.kw)

    def any_hit_warp(self, o, d, t_max):
        return tri_any_hit_warp(o, d, t_max, self.tris16, self.caabb, self.saabb,
                                self.slab_aabb, **self.kw)

    @property
    def plan(self) -> str:
        """The walk launch_plan picks for these tables."""
        return launch_plan(self.kw["block_t"])
