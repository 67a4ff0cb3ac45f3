"""Group-granular closest-hit and any-hit triangle traversal (K4): the
wrappers of the CUDA kernels in csrc/intersect_group.cu and their plain
PyTorch versions.

Counterpart of the JAX package's ops/pallas/intersect_group.py
(`tri_closest_hit_groups` / `tri_any_hit_groups`). It computes what K1 / K2
compute (intersect_kernel.py) on the same TriTables, walked per group of
GROUP_R consecutive rays: the group visits a cluster as soon as one of its
rays enters the cluster's box (and the group's slab and super boxes).

The plain versions keep the TPU kernel's group rule: every ray of the
group tests a visited cluster. The kernel tests a visited cluster's rows
only for the rays whose own box test passes in a non-strict form with a
slack, box_near <= t_best * GATE_SLACK (and t_best > 0; every visited
cluster for a bound of +inf) — the gate. A hit the group rule accepts has
t < t_best, or t == t_best == t_max as the ray's first hit. A triangle lies
inside its cluster's box, but its computed t can fall a few ulps below the
box's computed entry tn where it lies on a face of the box (an axis-aligned
wall; at most 6 × 2^-24 relative, measured by
tests/test_torch_intersect_group.py); the slack, 2^-16, covers that
crossing 40 times over, so a cluster the gate skips holds no hit the group
rule would accept, and t, rows and any-hit are the plain versions' bit for
bit. That rests on the measured bound, not on a proof for every triangle;
the tests and chip_smoke.py hold it on every batch they run. A gate without
the slack loses a hit on coplanar triangles split over clusters, and a
strict one also the first hit at exactly t_max in a cluster whose box_near
is t_max. K1 enters a cluster only when tn < t_best, so at those same
crossings its t and rows can differ from the group rule's; elsewhere t is
K1's and rows agree with K1's up to exact-t ties. `gate=True` runs the
plain versions under the gate (the kernel's work, the same outputs).

The tables are the row-major TriTables tensors K1 takes (tris16, caabb,
saabb, slab_aabb); the TPU layouts (`pack_rays_groups`' sublane groups,
`tris_lane_major`'s lane-major tiles) are not ported. The walk always has
the super level, so the wrappers raise unless clusters_per_slab is a
multiple of SUPER_G and saabb holds one box per SUPER_G clusters — the guard
the TPU kernel lacks. The JAX probe builds its tables at block_t 128,
clusters_per_slab 128, use_supers=True (`group_tables`).

For CPU tensors the wrappers run the plain versions (the group rule); for
CUDA tensors they launch the kernels or raise. With stats=True the plain
versions also count, per ray, the tiles it tested — under the group rule
the tiles its group tested (the G = 8 work of tools/probe_granularity.py);
with gate=True those the gate lets it test.
"""

from __future__ import annotations

import torch

from curry_pbrt_tpu_torch.ops.kernels.intersect_kernel import (
    SUPER_G,
    _any_plain,
    _box_near,
    _check,
    _closest_plain,
    _launch,
    _tri_tile,
    build_tri_tables,
)

GROUP_R = 8  # rays per predication group
GATE_SLACK = 1.0 + 2.0 ** -16  # the kernel's GATE_SLACK: exact in float32
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


def _gate(o, caabb):
    """narrow() of the plain walks under the kernel's gate: the rays whose
    own test of cluster c's box passes in the non-strict form with the
    slack (or whose bound is +inf)."""
    def narrow(c, inv_d, bound):
        return (((_box_near(caabb[c], o, inv_d) <= bound * GATE_SLACK) | torch.isinf(bound))
                & (bound > 0.0))
    return narrow


def tri_closest_hit_groups_plain(o, d, t_max, tris16, caabb, saabb, slab_aabb, *,
                                 block_t: int, clusters_per_slab: int, stats: bool = False,
                                 gate: bool = False):
    """Plain version of K4's closest hit: K1's walk, entered per group.
    Returns (t (N,) f32, FLOAT_MAX on miss; row (N,) int32, -1 on miss),
    plus per-ray (entered, improved) counts with stats — entered counts the
    tiles the ray tested: every tile its group tested, or with gate those
    the kernel's gate lets it test (the outputs are the same)."""
    n = o.shape[0]
    o, d, t_max = _padded(o, d, t_max)
    out = _closest_plain(_tri_tile(o, d), o, d, t_max, tris16, caabb, saabb, slab_aabb,
                         block_t, clusters_per_slab, True, stats, spread=_group_any,
                         narrow=_gate(o, caabb) if gate else None)
    return tuple(x[:n] for x in out)


def tri_any_hit_groups_plain(o, d, t_max, tris16, caabb, saabb, slab_aabb, *,
                             block_t: int, clusters_per_slab: int, stats: bool = False,
                             gate: bool = False):
    """Plain version of K4's any hit → (N,) bool, plus the per-ray count of
    the tiles it tested with stats (gate: see the closest hit)."""
    n = o.shape[0]
    o, d, t_max = _padded(o, d, t_max)
    out = _any_plain(_tri_tile(o, d), o, d, t_max, tris16, caabb, saabb, slab_aabb,
                     block_t, clusters_per_slab, True, stats, spread=_group_any,
                     narrow=_gate(o, caabb) if gate else None)
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
