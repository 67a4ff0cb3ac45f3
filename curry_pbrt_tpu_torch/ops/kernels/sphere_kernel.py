"""Sphere cluster traversal (K3): the host table construction, the wrappers
of the closest-hit and any-hit sphere kernels in csrc/intersect_warp.cu and
csrc/intersect.cu, and their plain PyTorch versions.

Counterpart of the JAX package's ops/pallas/sphere_kernel.py. A sphere is
one table row holding its world-to-object transform and radius; spheres are
kd-median ordered by world center into BLOCK_S-row clusters with AABBs,
grouped into supers and slabs and ordered front-to-back exactly as the
triangle tables are (`build_sphere_tables` is copied as it is, so both
packages build identical tables). The walk and its acceptance rule are the
triangle kernels' (intersect_kernel._closest_plain / _any_plain here, the
walks templated over the primitive on the card); only the per-pair test
differs: each ray goes into each sphere's object space through its raw
direction and the stable q-form quadratic is solved (reference
sphere.rs:111-132). Unlike a triangle hit, a sphere hit can be t = -0.0 (a
ray that starts on the surface and leaves it: c = +0 over q < 0); every
version returns that -0.0, sign included.

Sphere table layout (S_pad, 16) f32:
  cols 0-8  w2o rotation rows (r00 r01 r02 r10 .. r22)
  cols 9-11 w2o translation
  col 12    radius
  col 13    valid flag (+1/-1)

`sphere_closest_hit_tables` / `sphere_any_hit_tables` run the plain
versions for CPU tensors; for CUDA tensors they launch the walk that
intersect_kernel.launch_plan picks from block_s — the warp-cooperative walk
of csrc/intersect_warp.cu at the tables' 64 rows a cluster — and raise if it
cannot run: there is no fallback from the card to the plain code.
`sphere_closest_hit_warp` / `sphere_closest_hit_thread` (and the any-hit
pair) force one walk: the A/B of chip_smoke.py. Launches are counted in
intersect_kernel.LAUNCHES: sphere_closest / sphere_any for the warp walk,
sphere_closest_thread / sphere_any_thread for the per-thread walk.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX
from curry_pbrt_tpu_torch.ops.kernels.intersect_kernel import (
    SUPER_G,
    _any_plain,
    _check,
    _closest_outputs,
    _closest_plain,
    _launch,
    _round_up,
    kdmedian_order,
    launch_plan,
    union_boxes,
)
from curry_pbrt_tpu_torch.ops.math import safe_sqrt

BLOCK_S = 64  # spheres per cluster
SPH_COLS = 16


def _sphere_tile_test(rows, o, d, t_best):
    """Stable-quadratic test of rays (o, d: (n,3) raw directions) against
    sphere rows (B,16) → (n,B) t, FLOAT_MAX where there is no hit. The JAX
    kernel's _sphere_tile_test operation for operation: t0 if ≥ 0 else t1,
    rejected when t0 > t_best or t1 < 0 or t > t_best."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = (rows[None, :, k] for k in range(9))
    tx, ty, tz = rows[None, :, 9], rows[None, :, 10], rows[None, :, 11]
    radius = rows[None, :, 12]
    valid = rows[None, :, 13] > 0.0
    t_best = t_best[:, None]

    oox = m00 * ox + m01 * oy + m02 * oz + tx  # (n, B)
    ooy = m10 * ox + m11 * oy + m12 * oz + ty
    ooz = m20 * ox + m21 * oy + m22 * oz + tz
    ddx = m00 * dx + m01 * dy + m02 * dz
    ddy = m10 * dx + m11 * dy + m12 * dz
    ddz = m20 * dx + m21 * dy + m22 * dz

    a = ddx * ddx + ddy * ddy + ddz * ddz
    safe_a = torch.where(a == 0, 1.0, a)
    b_half = oox * ddx + ooy * ddy + ooz * ddz
    r2 = radius * radius
    c = oox * oox + ooy * ooy + ooz * ooz - r2
    t_center = -b_half / safe_a
    px = oox + t_center * ddx
    py = ooy + t_center * ddy
    pz = ooz + t_center * ddz
    perp2 = px * px + py * py + pz * pz
    disc_ok = (perp2 <= r2) & (a > 0)
    s = safe_sqrt(a * (r2 - perp2))  # the double-where square root
    sgn = torch.where(b_half >= 0, 1.0, -1.0)
    q = -(b_half + sgn * s)
    safe_q = torch.where(q == 0, 1.0, q)
    r1 = q / safe_a
    r2_ = torch.where(q == 0, r1, c / safe_q)
    t0 = torch.minimum(r1, r2_)
    t1 = torch.maximum(r1, r2_)
    t = torch.where(t0 >= 0.0, t0, t1)
    ok = valid & disc_ok & (t0 <= t_best) & (t1 >= 0.0) & (t <= t_best)
    return torch.where(ok, t, float(FLOAT_MAX))


@dataclasses.dataclass
class SphereTables:
    """Host-built sphere kernel tables (kd-ordered, slab-padded)."""

    sph16: np.ndarray  # (S_pad, 16)
    row_sphere: np.ndarray  # (S_pad,) i32 original sphere index, -1 pad
    cluster_aabbs: np.ndarray  # (C, 8)
    super_aabbs: np.ndarray
    slab_aabbs: np.ndarray
    block_s: int
    clusters_per_slab: int
    use_supers: bool


def build_sphere_tables(
    w2o, o2w, radius, prim,
    block_s: int = BLOCK_S,
    view_origin=None,
    clusters_per_slab: int = 256,
    use_supers=None,
) -> SphereTables:
    """kd-median-order spheres by world center, group block_s rows into
    AABB-carrying clusters (+supers/slabs as the tri tables), order
    front-to-back from view_origin. Invalid rows get valid=-1."""
    w2o = np.asarray(w2o, np.float32)
    o2w = np.asarray(o2w, np.float32)
    radius = np.asarray(radius, np.float32)
    prim = np.asarray(prim, np.int32)
    s = radius.shape[0]

    centers = o2w[:, :3, 3]
    # conservative world radius of the transformed object-space sphere
    # (same bound as the JAX package's ops/bvh._prim_bounds)
    rw = np.abs(o2w[:, :3, :3]).sum(axis=2).max(axis=1) * radius

    order = kdmedian_order(centers, centers, centers, block_s)
    w2o, o2w, radius, prim = w2o[order], o2w[order], radius[order], prim[order]
    centers, rw = centers[order], rw[order]

    nc_raw = -(-max(s, 1) // block_s)
    if use_supers is None:
        use_supers = nc_raw > 96
    use_supers = bool(use_supers)
    if use_supers or nc_raw > clusters_per_slab:
        nc = _round_up(nc_raw, SUPER_G)
        cps = int(min(clusters_per_slab, nc))
        n_slabs = -(-nc // cps)
        nc = n_slabs * cps
    else:
        nc, cps, n_slabs = nc_raw, nc_raw, 1
    s_pad = nc * block_s

    sph16 = np.zeros((s_pad, SPH_COLS), np.float32)
    sph16[:, 13] = -1.0
    sph16[:s, 0:9] = w2o[:, :3, :3].reshape(s, 9)
    sph16[:s, 9:12] = w2o[:, :3, 3]
    sph16[:s, 12] = radius
    sph16[:s, 13] = np.where(prim >= 0, 1.0, -1.0)
    row_sphere = np.concatenate(
        [order.astype(np.int32), np.full((s_pad - s,), -1, np.int32)]
    )

    valid = sph16[:, 13] > 0
    bmin = np.where(valid[:s, None], centers - rw[:, None], np.nan)
    bmax = np.where(valid[:s, None], centers + rw[:, None], np.nan)
    bmin = np.concatenate([bmin, np.full((s_pad - s, 3), np.nan, np.float32)])
    bmax = np.concatenate([bmax, np.full((s_pad - s, 3), np.nan, np.float32)])
    boxes8 = np.concatenate(
        [bmin, bmax, np.zeros((s_pad, 2), np.float32)], axis=-1
    ).astype(np.float32)
    caabb = union_boxes(boxes8.reshape(nc, block_s, 8))

    if view_origin is not None:
        vo = np.asarray(view_origin, np.float64)
        ccent = (caabb[:, 0:3].astype(np.float64) + caabb[:, 3:6]) * 0.5
        cdist = np.linalg.norm(ccent - vo, axis=-1)
        cdist = np.where(np.isnan(cdist), np.inf, cdist)
        ns = nc // SUPER_G
        if nc % SUPER_G == 0:
            sdist = cdist.reshape(ns, SUPER_G).min(axis=1)
            sorder = np.argsort(sdist, kind="stable")
            within = np.argsort(cdist.reshape(ns, SUPER_G), axis=1, kind="stable")
            cluster_order = (sorder[:, None] * SUPER_G + within[sorder]).reshape(-1)
        else:
            cluster_order = np.argsort(cdist, kind="stable")
        row_order = (
            cluster_order[:, None] * block_s + np.arange(block_s)[None, :]
        ).reshape(-1)
        sph16, row_sphere = sph16[row_order], row_sphere[row_order]
        caabb = caabb[cluster_order]

    use_supers = use_supers and cps > SUPER_G
    ns = nc // SUPER_G
    if use_supers:
        saabb = union_boxes(caabb.reshape(ns, SUPER_G, 8))
    else:
        saabb = union_boxes(caabb[None, :, :])
    slab_aabb = union_boxes(caabb.reshape(n_slabs, cps, 8))

    return SphereTables(
        sph16=sph16, row_sphere=row_sphere, cluster_aabbs=caabb,
        super_aabbs=saabb, slab_aabbs=slab_aabb, block_s=block_s,
        clusters_per_slab=cps, use_supers=use_supers,
    )


# ---------------------------------------------------------------------------
# plain PyTorch versions


def _sph_tile(o, d):
    return lambda rows, ids, tb: _sphere_tile_test(rows, o[ids], d[ids], tb)


def sphere_closest_hit_plain(o, d, t_max, sph16, caabb, saabb, slab_aabb, *,
                             block_s: int, clusters_per_slab: int, use_supers: bool,
                             stats: bool = False):
    """Plain version of the sphere closest-hit kernel → (t (N,) f32,
    FLOAT_MAX on miss; row (N,) int32 table row, -1 on miss), plus per-ray
    (entered, improved) tile counts with stats (the kernel has no stats)."""
    return _closest_plain(_sph_tile(o, d), o, d, t_max, sph16, caabb, saabb, slab_aabb,
                          block_s, clusters_per_slab, use_supers, stats)


def sphere_any_hit_plain(o, d, t_max, sph16, caabb, saabb, slab_aabb, *,
                         block_s: int, clusters_per_slab: int, use_supers: bool,
                         stats: bool = False):
    """Plain version of the sphere any-hit kernel → (N,) bool, plus the
    per-ray count of entered tiles with stats."""
    return _any_plain(_sph_tile(o, d), o, d, t_max, sph16, caabb, saabb, slab_aabb,
                      block_s, clusters_per_slab, use_supers, stats)


# ---------------------------------------------------------------------------
# wrappers


def _closest(walk, o, d, t_max, sph16, caabb, saabb, slab_aabb, block_s, clusters_per_slab,
             use_supers):
    args = (o, d, t_max, sph16, caabb, saabb, slab_aabb)
    _check(*args, block_s, clusters_per_slab, use_supers)
    if o.device.type == "cpu":
        return sphere_closest_hit_plain(*args, block_s=block_s,
                                        clusters_per_slab=clusters_per_slab,
                                        use_supers=use_supers)
    walk = walk or launch_plan(block_s)
    outs = _closest_outputs(o, stats=False)
    _launch("curry_sphere_closest_hit_" + walk,
            "sphere_closest_thread" if walk == "thread" else "sphere_closest", outs, *args,
            block_s, clusters_per_slab, use_supers)
    return tuple(outs)


def _any(walk, o, d, t_max, sph16, caabb, saabb, slab_aabb, block_s, clusters_per_slab,
         use_supers):
    args = (o, d, t_max, sph16, caabb, saabb, slab_aabb)
    _check(*args, block_s, clusters_per_slab, use_supers)
    if o.device.type == "cpu":
        return sphere_any_hit_plain(*args, block_s=block_s, clusters_per_slab=clusters_per_slab,
                                    use_supers=use_supers)
    walk = walk or launch_plan(block_s)
    hit = torch.empty((o.shape[0],), dtype=torch.bool, device=o.device)
    _launch("curry_sphere_any_hit_" + walk,
            "sphere_any_thread" if walk == "thread" else "sphere_any", [hit], *args, block_s,
            clusters_per_slab, use_supers)
    return hit


def sphere_closest_hit_tables(o, d, t_max, sph16, caabb, saabb, slab_aabb, *,
                              block_s: int, clusters_per_slab: int, use_supers: bool):
    """Closest hit over SphereTables tensors → (t: (N,) f32, FLOAT_MAX on
    miss; row: (N,) int32 table row, -1 on miss; row_sphere maps it to the
    sphere). CPU tensors → plain version; CUDA tensors → the walk
    launch_plan picks from block_s (the warp walk at 64 rows a cluster)."""
    return _closest(None, o, d, t_max, sph16, caabb, saabb, slab_aabb, block_s,
                    clusters_per_slab, use_supers)


def sphere_any_hit_tables(o, d, t_max, sph16, caabb, saabb, slab_aabb, *,
                          block_s: int, clusters_per_slab: int, use_supers: bool):
    """Any-hit over SphereTables tensors → (N,) bool. CPU tensors → plain
    version; CUDA tensors → the walk launch_plan picks."""
    return _any(None, o, d, t_max, sph16, caabb, saabb, slab_aabb, block_s, clusters_per_slab,
                use_supers)


def sphere_closest_hit_warp(o, d, t_max, sph16, caabb, saabb, slab_aabb, *,
                            block_s: int, clusters_per_slab: int, use_supers: bool):
    """sphere_closest_hit_tables through the warp walk
    (csrc/intersect_warp.cu) whatever the plan."""
    return _closest("warp", o, d, t_max, sph16, caabb, saabb, slab_aabb, block_s,
                    clusters_per_slab, use_supers)


def sphere_any_hit_warp(o, d, t_max, sph16, caabb, saabb, slab_aabb, *,
                        block_s: int, clusters_per_slab: int, use_supers: bool):
    """sphere_any_hit_tables through the warp walk whatever the plan."""
    return _any("warp", o, d, t_max, sph16, caabb, saabb, slab_aabb, block_s,
                clusters_per_slab, use_supers)


def sphere_closest_hit_thread(o, d, t_max, sph16, caabb, saabb, slab_aabb, *,
                              block_s: int, clusters_per_slab: int, use_supers: bool):
    """sphere_closest_hit_tables through the per-thread walk
    (csrc/intersect.cu, one thread per ray) whatever the plan: the A/B
    baseline."""
    return _closest("thread", o, d, t_max, sph16, caabb, saabb, slab_aabb, block_s,
                    clusters_per_slab, use_supers)


def sphere_any_hit_thread(o, d, t_max, sph16, caabb, saabb, slab_aabb, *,
                          block_s: int, clusters_per_slab: int, use_supers: bool):
    """sphere_any_hit_tables through the per-thread walk whatever the plan."""
    return _any("thread", o, d, t_max, sph16, caabb, saabb, slab_aabb, block_s,
                clusters_per_slab, use_supers)


class DeviceSphereTables:
    """SphereTables arrays as tensors on one device, with the kernel keywords."""

    def __init__(self, tables: SphereTables, device):
        as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
        self.sph16 = as_t(tables.sph16)
        self.caabb = as_t(tables.cluster_aabbs)
        self.saabb = as_t(tables.super_aabbs)
        self.slab_aabb = as_t(tables.slab_aabbs)
        self.row_sphere = as_t(tables.row_sphere)
        self.kw = dict(block_s=tables.block_s, clusters_per_slab=tables.clusters_per_slab,
                       use_supers=tables.use_supers)

    def _tables(self):
        return self.sph16, self.caabb, self.saabb, self.slab_aabb

    def closest(self, o, d, t_max):
        return sphere_closest_hit_tables(o, d, t_max, *self._tables(), **self.kw)

    def any_hit(self, o, d, t_max):
        return sphere_any_hit_tables(o, d, t_max, *self._tables(), **self.kw)

    def closest_warp(self, o, d, t_max):
        return sphere_closest_hit_warp(o, d, t_max, *self._tables(), **self.kw)

    def any_hit_warp(self, o, d, t_max):
        return sphere_any_hit_warp(o, d, t_max, *self._tables(), **self.kw)

    def closest_thread(self, o, d, t_max):
        return sphere_closest_hit_thread(o, d, t_max, *self._tables(), **self.kw)

    def any_hit_thread(self, o, d, t_max):
        return sphere_any_hit_thread(o, d, t_max, *self._tables(), **self.kw)

    @property
    def plan(self) -> str:
        """The walk launch_plan picks for these tables."""
        return launch_plan(self.kw["block_s"])
