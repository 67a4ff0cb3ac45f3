"""Kernel-backed aggregate: closest-hit, any-hit and (t, prim) intersectors
over a compiled scene (counterpart of the JAX package's
ops/pallas/aggregate.py).

Triangles go through the CUDA traversal kernels of intersect_kernel.py (or
their plain versions on the CPU) over host-built cluster tables; spheres go
through the dense (rays × spheres) test below 129 spheres and through the
sphere cluster kernel (sphere_kernel.py) from 129 up. Hit attributes are
reconstructed only for each ray's winning primitive. Geometry is detached:
nothing differentiates through the traversal.

Beyond 512 triangle clusters every triangle traversal first sorts its rays
by (direction octant, origin Morton cell), dead lanes last, and un-permutes
the results: the JAX package's "oct_cell" ray sort. Each CUDA thread walks
its own ray, so the sort changes no result, only which rays share a warp.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX
from curry_pbrt_tpu_torch.ops import intersect as isect
from curry_pbrt_tpu_torch.ops.kernels.intersect_kernel import DeviceTables, build_tri_tables
from curry_pbrt_tpu_torch.ops.kernels.sphere_kernel import DeviceSphereTables, build_sphere_tables

SPHERE_KERNEL_MIN = 129  # the JAX package's sphere-kernel threshold
SMALL_SCENE_TRIS = 512  # up to this many triangles: 8-tri clusters, no ray sort
SORT_MIN_CLUSTERS = 512  # the ray sort is on beyond this many clusters
DEAD_KEY = 1 << 14  # sort key of dead lanes (t_max <= 0): after every live key

# Traversals that ran on sorted rays since the last reset.
RAY_SORTS = {"traversals": 0}


def plan_tri_kernel(tris: isect.TriangleArrays, view_origin=None):
    """Host tables with the JAX package's scene-adaptive cluster size:
    small scenes (≤ 512 tris) get 8-tri clusters so their handful of
    surfaces cull each other; beyond 256k tris 128-tri kd cells, otherwise
    64."""
    small = tris.count <= SMALL_SCENE_TRIS
    block_t = 8 if small else (128 if tris.count > 256 * 1024 else 64)
    return build_tri_tables(tris.p0, tris.p1, tris.p2, tris.prim,
                            block_t=block_t, view_origin=view_origin)


def sort_key(o, d, t_max, lo3, ext3):
    """(N,) int64 ray-sort key: direction octant (high) × the origin's 8³
    Morton cell in the box lo3 + [0, ext3] (low); dead lanes DEAD_KEY. The
    origin is clipped in float before the integer cast, as the JAX package
    does (a post-cast clip would misplace origins outside the scene box)."""
    q = torch.clamp((o - lo3) / ext3 * 8.0, 0.0, 7.0).to(torch.int64)

    def spread3(x):  # 3 bits → every 3rd bit
        x = (x | (x << 4)) & 0x0C3
        return (x | (x << 2)) & 0x249

    cell = (spread3(q[:, 0]) << 2) | (spread3(q[:, 1]) << 1) | spread3(q[:, 2])
    octant = ((d[:, 0] < 0).to(torch.int64) * 4 + (d[:, 1] < 0).to(torch.int64) * 2
              + (d[:, 2] < 0).to(torch.int64))
    return torch.where(t_max > 0, octant * 512 + cell, DEAD_KEY)


def make_kernel_intersectors(tris: isect.TriangleArrays, sph: isect.SphereArrays,
                             device, view_origin=None, ray_sort: Optional[bool] = None):
    """Returns (intersect, predicate, intersect_tprim) callables over rays
    (o, d: (N,3), t_max: (N,)) on `device`. tris/sph hold the compiler's
    host numpy arrays. view_origin (world-space camera position) orders
    clusters front-to-back. ray_sort: None sorts the rays of each triangle
    traversal beyond SORT_MIN_CLUSTERS clusters (the JAX package's
    default); True / False force it on or off (never on a small scene)."""
    # "have" means VALID rows: scenes keep one padding row in empty tables
    have_tris = bool((np.asarray(tris.prim) >= 0).any())
    have_sph = bool((np.asarray(sph.prim) >= 0).any())
    n_sph = int((np.asarray(sph.prim) >= 0).sum())
    use_sph_kernel = have_sph and n_sph >= SPHERE_KERNEL_MIN

    def as_t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    if use_sph_kernel:
        sdev = DeviceSphereTables(
            build_sphere_tables(sph.w2o, sph.o2w, sph.radius, sph.prim, view_origin=view_origin),
            device)
    sph = isect.SphereArrays(as_t(sph.o2w), as_t(sph.w2o), as_t(sph.radius), as_t(sph.prim))
    use_sort = False
    if have_tris:
        tables = plan_tri_kernel(tris, view_origin)
        dev = DeviceTables(tables, device)
        small = tris.count <= SMALL_SCENE_TRIS
        auto = tables.cluster_aabbs.shape[0] > SORT_MIN_CLUSTERS
        use_sort = not small and (auto if ray_sort is None else bool(ray_sort))
        if use_sort:
            sb = tables.slab_aabbs
            lo3 = np.nanmin(sb[:, 0:3], axis=0)
            ext3 = np.maximum(np.nanmax(sb[:, 3:6], axis=0) - lo3, 1e-6)
            lo3, ext3 = as_t(lo3), as_t(ext3)
        # kernel rows → permuted triangle table, which carries the prim ids
        tris = isect.TriangleArrays(as_t(tables.p0), as_t(tables.p1),
                                    as_t(tables.p2), as_t(tables.prim))

    def _sorted(fn, o, d, t_max):
        """fn over the rays in sort-key order, results back in ray order."""
        if not use_sort:
            return fn(o, d, t_max)
        perm = torch.argsort(sort_key(o, d, t_max, lo3, ext3), stable=True)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(perm.shape[0], device=perm.device)
        out = fn(o[perm], d[perm], t_max[perm])
        RAY_SORTS["traversals"] += 1
        return tuple(x[inv] for x in out) if isinstance(out, tuple) else out[inv]

    def _tri_closest(o, d, t_max):
        t, idx = _sorted(dev.closest, o, d, t_max)
        return t, idx, idx >= 0

    def _sph_closest(o, d, t_max):
        """→ (t (N,), best sphere index (N,), hit (N,) bool). On the dense
        path the lowest index wins an exact-t tie; the kernel's tie winner
        follows table order."""
        if use_sph_kernel:
            t, row = sdev.closest(o, d, t_max)
            best = sdev.row_sphere[torch.clamp(row, 0, sdev.row_sphere.shape[0] - 1).long()]
            return t, torch.clamp(best, min=0).long(), row >= 0
        st, sok = isect.sphere_intersect_t(o, d, t_max, sph)
        t_min, best = torch.min(st, dim=-1)
        return t_min, best, torch.gather(sok, 1, best[:, None])[:, 0]

    def _sph_any(o, d, t_max):
        if use_sph_kernel:
            return sdev.any_hit(o, d, t_max)
        return torch.any(isect.sphere_intersect_t(o, d, t_max, sph)[1], dim=-1)

    def intersect(o, d, t_max) -> isect.Hit:
        N = o.shape[0]
        z3 = torch.zeros((N, 3), dtype=torch.float32, device=o.device)
        p, n, perr = z3, z3, z3
        uv = torch.zeros((N, 2), dtype=torch.float32, device=o.device)
        prim = torch.full((N,), -1, dtype=torch.int32, device=o.device)
        t_out = torch.full((N,), float(FLOAT_MAX), dtype=torch.float32, device=o.device)

        if have_tris:
            tri_t, tri_idx, tri_hit = _tri_closest(o, d, t_max)
        if have_sph:
            sph_t, sph_best, sph_hit = _sph_closest(o, d, t_max)

        if have_tris and have_sph:
            use_tri = tri_hit & (~sph_hit | (tri_t <= sph_t))
            use_sph = sph_hit & ~use_tri
        elif have_tris:
            use_tri = tri_hit
        elif have_sph:
            use_sph = sph_hit
        else:
            return isect.Hit(t_out, prim, p, n, uv, perr)

        if have_tris:
            safe_idx = torch.clamp(tri_idx, 0, tris.count - 1).long()
            tp, tn, tuv, terr = isect.triangle_winner_attributes(o, d, t_max, safe_idx, tris)
            m = use_tri[:, None]
            p = torch.where(m, tp, p)
            n = torch.where(m, tn, n)
            uv = torch.where(m, tuv, uv)
            perr = torch.where(m, terr, perr)
            t_out = torch.where(use_tri, tri_t, t_out)
            prim = torch.where(use_tri, tris.prim[safe_idx], prim)
        if have_sph:
            sp, sn, suv, serr = isect.sphere_hit_attributes(sph_best, sph_t, o, d, sph)
            m = use_sph[:, None]
            p = torch.where(m, sp, p)
            n = torch.where(m, sn, n)
            uv = torch.where(m, suv, uv)
            perr = torch.where(m, serr, perr)
            t_out = torch.where(use_sph, sph_t, t_out)
            prim = torch.where(use_sph, sph.prim[sph_best], prim)
        return isect.Hit(t_out, prim, p, n, uv, perr)

    def predicate(o, d, t_max):
        hit = torch.zeros(o.shape[:1], dtype=torch.bool, device=o.device)
        if have_tris:
            hit = hit | _sorted(dev.any_hit, o, d, t_max)
        if have_sph:
            hit = hit | _sph_any(o, d, t_max)
        return hit

    def intersect_tprim(o, d, t_max):
        """(t, prim) only — skips the winner-attribute pass."""
        N = o.shape[0]
        t_out = torch.full((N,), float(FLOAT_MAX), dtype=torch.float32, device=o.device)
        prim = torch.full((N,), -1, dtype=torch.int32, device=o.device)
        if have_tris:
            tri_t, tri_idx, tri_hit = _tri_closest(o, d, t_max)
            safe_idx = torch.clamp(tri_idx, 0, tris.count - 1).long()
            t_out = torch.where(tri_hit, tri_t, t_out)
            prim = torch.where(tri_hit, tris.prim[safe_idx], prim)
        if have_sph:
            sph_t, sph_best, sph_hit = _sph_closest(o, d, t_max)
            use = sph_hit & (sph_t < t_out)
            t_out = torch.where(use, sph_t, t_out)
            prim = torch.where(use, sph.prim[sph_best], prim)
        return t_out, prim

    def _detached(fn):
        """Geometry gradients stop at the traversal (the kernels have no
        backward; the design differentiates parameters, not geometry
        edges)."""

        def wrapped(o, d, t_max):
            return fn(o.detach(), d.detach(), t_max.detach())

        return wrapped

    return _detached(intersect), _detached(predicate), _detached(intersect_tprim)
