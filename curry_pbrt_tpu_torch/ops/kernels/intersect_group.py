"""Group-granular closest-hit and any-hit triangle traversal (K4): the
wrappers of the CUDA kernels in csrc/intersect_group.cu and their plain
PyTorch versions.

Counterpart of the JAX package's ops/pallas/intersect_group.py
(`tri_closest_hit_groups` / `tri_any_hit_groups`). It computes what K1 / K2
compute (intersect_kernel.py) on the same TriTables, with the tile tests
gated per group of GROUP_R consecutive rays: every ray of a group tests a
cluster as soon as one ray of the group enters the cluster's box (and the
group's slab and super boxes). The box test is conservative, so t is
bit-equal to K1's and rows agree up to exact-t ties; only the work differs.

The tables are the row-major TriTables tensors K1 takes (tris16, caabb,
saabb, slab_aabb); the TPU layouts (`pack_rays_groups`' sublane groups,
`tris_lane_major`'s lane-major tiles) are not ported. The walk always has
the super level, so the wrappers raise unless clusters_per_slab is a
multiple of SUPER_G and saabb holds one box per SUPER_G clusters — the guard
the TPU kernel lacks. The JAX probe builds its tables at block_t 128,
clusters_per_slab 128, use_supers=True (`group_tables`).

For CPU tensors the wrappers run the plain versions; for CUDA tensors they
launch the kernels or raise. With stats=True the plain versions also count,
per ray, the tiles its group tested — the group-granular (G = 8) work of
tools/probe_granularity.py.
"""

from __future__ import annotations

import torch

from curry_pbrt_tpu_torch.ops.kernels.intersect_kernel import (
    SUPER_G,
    _any_plain,
    _check,
    _closest_plain,
    _launch,
    _tri_tile,
    build_tri_tables,
)

GROUP_R = 8  # rays per predication group
GROUP_BLOCK_T = 128  # the JAX probe's tables: 128-tri clusters,
GROUP_CPS = 128  # 128 clusters per slab, with supers


def group_tables(p0, p1, p2, prim, view_origin=None, block_t: int = GROUP_BLOCK_T,
                 clusters_per_slab: int = GROUP_CPS):
    """build_tri_tables as the JAX group probe builds them
    (tools/probe_group_kernel.py:99-103): supers on."""
    return build_tri_tables(p0, p1, p2, prim, block_t=block_t, view_origin=view_origin,
                            clusters_per_slab=clusters_per_slab, use_supers=True)


def _check_groups(o, d, t_max, tris16, caabb, saabb, slab_aabb, block_t, cps):
    _check(o, d, t_max, tris16, caabb, saabb, slab_aabb, block_t, cps, False)
    nc = caabb.shape[0]
    if cps % SUPER_G or saabb.shape != (nc // SUPER_G, 8):
        raise ValueError(
            f"the group kernel walks supers: it needs clusters_per_slab % {SUPER_G} == 0 and "
            f"one super box per {SUPER_G} clusters ({nc // SUPER_G}, 8); got clusters_per_slab "
            f"{cps}, saabb {tuple(saabb.shape)} (tables built with use_supers=True)")


def _group_any(mask):
    """(N,) per-ray mask → the rays of every group of GROUP_R with a True."""
    return mask.view(-1, GROUP_R).any(dim=1).repeat_interleave(GROUP_R)


def _padded(o, d, t_max):
    """Pad the rays to whole groups with dead rays (t_max 0)."""
    pad = -o.shape[0] % GROUP_R
    if not pad:
        return o, d, t_max
    dead_d = torch.zeros((pad, 3), dtype=d.dtype, device=d.device)
    dead_d[:, 2] = 1.0
    return (torch.cat([o, torch.zeros((pad, 3), dtype=o.dtype, device=o.device)]),
            torch.cat([d, dead_d]),
            torch.cat([t_max, torch.zeros((pad,), dtype=t_max.dtype, device=t_max.device)]))


def tri_closest_hit_groups_plain(o, d, t_max, tris16, caabb, saabb, slab_aabb, *,
                                 block_t: int, clusters_per_slab: int, stats: bool = False):
    """Plain version of K4's closest hit: K1's walk with group-gated
    entry. Returns (t (N,) f32, FLOAT_MAX on miss; row (N,) int32, -1 on
    miss), plus per-ray (entered, improved) counts with stats — entered
    counts the tiles the ray's group tested."""
    n = o.shape[0]
    o, d, t_max = _padded(o, d, t_max)
    out = _closest_plain(_tri_tile(o, d), o, d, t_max, tris16, caabb, saabb, slab_aabb,
                         block_t, clusters_per_slab, True, stats, spread=_group_any)
    return tuple(x[:n] for x in out)


def tri_any_hit_groups_plain(o, d, t_max, tris16, caabb, saabb, slab_aabb, *,
                             block_t: int, clusters_per_slab: int, stats: bool = False):
    """Plain version of K4's any hit → (N,) bool, plus the per-ray count of
    the tiles its group tested with stats."""
    n = o.shape[0]
    o, d, t_max = _padded(o, d, t_max)
    out = _any_plain(_tri_tile(o, d), o, d, t_max, tris16, caabb, saabb, slab_aabb,
                     block_t, clusters_per_slab, True, stats, spread=_group_any)
    return tuple(x[:n] for x in out) if stats else out[:n]


def tri_closest_hit_groups(o, d, t_max, tris16, caabb, saabb, slab_aabb, *,
                           block_t: int, clusters_per_slab: int):
    """Group-granular closest hit over TriTables tensors (supers required).
    Returns (t (N,) f32, FLOAT_MAX on miss; row (N,) int32 table row, -1 on
    miss). CPU tensors → plain version; CUDA tensors → the CUDA kernel."""
    args = (o, d, t_max, tris16, caabb, saabb, slab_aabb)
    _check_groups(*args, block_t, clusters_per_slab)
    if o.device.type == "cpu":
        return tri_closest_hit_groups_plain(*args, block_t=block_t,
                                            clusters_per_slab=clusters_per_slab)
    n, dev = o.shape[0], o.device
    outs = [torch.empty((n,), dtype=torch.float32, device=dev),
            torch.empty((n,), dtype=torch.int32, device=dev)]
    _launch("curry_tri_closest_hit_groups", "tri_closest_group", outs, *args, block_t,
            clusters_per_slab, True)
    return tuple(outs)


def tri_any_hit_groups(o, d, t_max, tris16, caabb, saabb, slab_aabb, *,
                       block_t: int, clusters_per_slab: int):
    """Group-granular any hit (shadow test) → (N,) bool. CPU tensors →
    plain version; CUDA tensors → the CUDA kernel."""
    args = (o, d, t_max, tris16, caabb, saabb, slab_aabb)
    _check_groups(*args, block_t, clusters_per_slab)
    if o.device.type == "cpu":
        return tri_any_hit_groups_plain(*args, block_t=block_t,
                                        clusters_per_slab=clusters_per_slab)
    hit = torch.empty((o.shape[0],), dtype=torch.bool, device=o.device)
    _launch("curry_tri_any_hit_groups", "tri_any_group", [hit], *args, block_t,
            clusters_per_slab, True)
    return hit


def group_kw(tables) -> dict:
    """The K4 keywords of a DeviceTables (its use_supers is implied)."""
    return {k: v for k, v in tables.kw.items() if k != "use_supers"}
