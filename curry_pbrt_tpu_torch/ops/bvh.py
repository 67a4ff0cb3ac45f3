"""Flat threaded BVH: host SAH build → arrays → stackless traversal
(counterpart of the JAX package's ops/bvh.py; the `intersector="bvh"`
backend).

The device structure is a THREADED BVH: every node carries a `hit` link
(next node in depth-first order) and a `miss` link (the sibling-or-ancestor
escape), so a traversal is one node pointer per ray — no stack:

    ptr = 0
    while ptr != END:
        enter = slab_test(node[ptr].bounds, ray, t_best)
        if node[ptr] is a leaf and enter: test its <= LEAF_SIZE prims, shrink t_best
        ptr = enter ? node[ptr].hit : node[ptr].miss

The SAH build replicates the reference cost model (bvh.rs:24-124): full
sort per axis, prefix/suffix bound sweeps, cost = 0.125 + (n_L·SA_L +
n_R·SA_R)/SA_P, leaf when the best cost exceeds the primitive count,
oversize leaves chained as fixed-width leaf nodes. It runs in C++
(ops/bvh_native.py; a failed build raises), and the arrays are those of
both of the JAX package's builders.

`bvh_traverse` here is the PLAIN version of the traversal: the JAX
package's lockstep loop over per-ray node pointers, as eager PyTorch on the
live rays. The card runs the live-ray walk of csrc/bvh_walk.cu instead
(ops/kernels/bvh_kernel.py, which picks one or the other by the rays'
device and builds the renderer's intersectors on them). The walk reads each
node as one 32-byte row of `DeviceBVH.nodes` (`pack_nodes`); the plain
version reads the separate arrays. The rules are the
JAX package's: the slab test of bounds.rs:303-323 (cached 1/d with d == 0 → 1e-30, sign-selected slabs, (1 + 2γ₃) on the far
distances only, tn <= tf, tn < t_best, tf > 0); within a leaf the slots in
order, a slot's hit accepted on strict t < t_best; an any-hit ray stops at
the end of the leaf that gave its first hit. One difference: a ray with
t_max <= 0 (the integrators' dead lanes) starts at END, where the JAX loop
walks it (it can only report a sphere hit at exactly t = 0).

The leaf tests are ops/intersect.watertight_core and sphere_quadratic, the
ray taken into a sphere's object space by the fixed-order sums of
_mat3_vec (the JAX package uses an einsum there); csrc/bvh_walk.cu repeats
them op for op.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX, Float
from curry_pbrt_tpu_torch.ops import bvh_native
from curry_pbrt_tpu_torch.ops import intersect as isect
from curry_pbrt_tpu_torch.ops.kernels.intersect_kernel import T_SCALE, pack_tris_np

LEAF_SIZE = 4
END = np.int32(-1)
NODE_COLS = 8  # DeviceBVH.nodes: bmin xyz, miss | bmax xyz, first << COUNT_BITS | count
COUNT_BITS = 3  # count <= LEAF_SIZE < 2**COUNT_BITS
_FMAX = float(FLOAT_MAX)
ROW_COLS = 16  # tris16 / sph16 rows (ops/kernels/intersect_kernel, sphere_kernel)


class FlatBVH(NamedTuple):
    """Host numpy arrays."""

    bmin: np.ndarray  # (M,3)
    bmax: np.ndarray  # (M,3)
    hit: np.ndarray  # (M,) i32 next-if-enter
    miss: np.ndarray  # (M,) i32 next-if-skip
    first: np.ndarray  # (M,) i32 first prim slot (leaves), -1 internal
    count: np.ndarray  # (M,) i32 ≤ LEAF_SIZE
    prim_refs: np.ndarray  # (K,) i32: tri index, or n_tris + sphere index
    n_tris: int

    @property
    def n_nodes(self) -> int:
        return int(self.bmin.shape[0])


# ---------------------------------------------------------------------------
# host build (the JAX package's functions)


def _prim_bounds(scene) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-primitive AABBs + encoded refs. Returns (bmin (P,3), bmax, refs)."""
    p0 = np.asarray(scene.tris.p0)
    p1 = np.asarray(scene.tris.p1)
    p2 = np.asarray(scene.tris.p2)
    tri_valid = np.asarray(scene.tris.prim) >= 0
    tmin = np.minimum(np.minimum(p0, p1), p2)[tri_valid]
    tmax = np.maximum(np.maximum(p0, p1), p2)[tri_valid]
    tri_refs = np.nonzero(tri_valid)[0].astype(np.int32)

    o2w = np.asarray(scene.spheres.o2w)
    radius = np.asarray(scene.spheres.radius)
    sph_valid = np.asarray(scene.spheres.prim) >= 0
    centers = o2w[:, :3, 3][sph_valid]
    # conservative world AABB of a transformed object-space sphere
    r = (np.abs(o2w[:, :3, :3]).sum(axis=2).max(axis=1) * radius)[sph_valid]
    smin = centers - r[:, None]
    smax = centers + r[:, None]
    n_tris = int(np.asarray(scene.tris.p0).shape[0])
    sph_refs = (np.nonzero(sph_valid)[0] + n_tris).astype(np.int32)

    bmin = np.concatenate([tmin, smin], axis=0)
    bmax = np.concatenate([tmax, smax], axis=0)
    refs = np.concatenate([tri_refs, sph_refs])
    return bmin.astype(np.float32), bmax.astype(np.float32), refs


def build_flat_bvh(scene) -> FlatBVH:
    """The flat BVH over a scene's valid triangles and spheres (scene: any
    object with the compiler's `tris` and `spheres` arrays), built by the
    C++ builder of ops/bvh_native.py, which raises if it cannot be built."""
    bmin, bmax, refs = _prim_bounds(scene)
    n_tris = int(np.asarray(scene.tris.p0).shape[0])
    if len(refs) == 0:
        z3 = np.zeros((1, 3), np.float32)
        end = np.full((1,), END, np.int32)
        zero = np.zeros((1,), np.int32)
        return FlatBVH(z3, z3, end, end.copy(), zero, zero.copy(), zero.copy(), n_tris)
    flat = bvh_native.sah_build_flat(bmin, bmax)
    return FlatBVH(bmin=flat["bmin"], bmax=flat["bmax"], hit=flat["hit"], miss=flat["miss"],
                   first=flat["first"], count=flat["count"],
                   prim_refs=refs[flat["order"]].astype(np.int32), n_tris=n_tris)


class DeviceBVH(NamedTuple):
    """A FlatBVH and its primitives as tensors on one device: the node
    fields as separate arrays (the plain version's) and as one row a node
    (`nodes`, the kernel's; pack_nodes), the primitives as 16-column rows
    (tris16: p0, p1, p2, a ±1 valid flag; sph16: the world-to-object
    rotation rows, its translation, the radius, a ±1 valid flag), indexed
    by prim_refs."""

    bmin: torch.Tensor  # (M,3) f32
    bmax: torch.Tensor  # (M,3) f32
    hit: torch.Tensor  # (M,) i32
    miss: torch.Tensor  # (M,) i32
    first: torch.Tensor  # (M,) i32
    count: torch.Tensor  # (M,) i32
    prim_refs: torch.Tensor  # (K,) i32
    tris16: torch.Tensor  # (max(T,1), 16) f32
    sph16: torch.Tensor  # (max(S,1), 16) f32
    n_tris: int
    nodes: torch.Tensor  # (M, NODE_COLS) f32, pack_nodes

    @property
    def n_nodes(self) -> int:
        return int(self.bmin.shape[0])


def pack_nodes(bvh: FlatBVH) -> np.ndarray:
    """The (M, 8) float32 node rows of the live-ray walk (csrc/bvh_walk.cu),
    32 bytes a node: words 0-3 bmin xyz and the miss link's int32 bits,
    words 4-7 bmax xyz and the bits of first << COUNT_BITS | count (first -1
    on an internal node). The hit link is not stored: the builder makes it
    the next node (ptr + 1) for an internal node and the miss link for a
    leaf piece (csrc/bvh_builder.cpp Emitter::emit), and the walk relies on
    that. Raises ValueError where the BVH breaks it or a field does not
    fit."""
    m = bvh.n_nodes
    ptr = np.arange(m, dtype=np.int64)
    hit, miss = bvh.hit.astype(np.int64), bvh.miss.astype(np.int64)
    first, count = bvh.first.astype(np.int64), bvh.count.astype(np.int64)
    internal = first < 0
    if not np.array_equal(hit[internal], ptr[internal] + 1):
        raise ValueError("an internal node's hit link is not the next node: the node rows "
                         "cannot drop it")
    if not np.array_equal(hit[~internal], miss[~internal]):
        raise ValueError("a leaf's hit link is not its miss link: the node rows cannot drop it")
    if (first < -1).any() or (count < 0).any() or (count > LEAF_SIZE).any() or (
            internal & (count != 0)).any():
        raise ValueError(f"leaf ranges must be first >= -1 (-1 internal, count 0) and 0 <= "
                         f"count <= {LEAF_SIZE}")
    if m and first.max() >= 2 ** (31 - COUNT_BITS):
        raise ValueError(f"first slot {int(first.max())} does not fit a node row's "
                         f"{31 - COUNT_BITS} bits")
    rows = np.empty((m, NODE_COLS), np.int32)
    rows[:, 0:3] = np.ascontiguousarray(bvh.bmin, np.float32).view(np.int32)
    rows[:, 3] = miss
    rows[:, 4:7] = np.ascontiguousarray(bvh.bmax, np.float32).view(np.int32)
    rows[:, 7] = (first << COUNT_BITS) | count
    return rows.view(np.float32)


def pack_rows(tris, spheres):
    """(tris16, sph16) host rows of the scene's triangles and spheres in
    their own order (at least one row each; padding rows carry -1)."""
    tris16 = pack_tris_np(*(np.asarray(a, np.float32) for a in (tris.p0, tris.p1, tris.p2)),
                          np.asarray(tris.prim) >= 0)
    if tris16.shape[0] == 0:
        tris16 = np.zeros((1, ROW_COLS), np.float32)
        tris16[:, 9] = -1.0
    w2o = np.asarray(spheres.w2o, np.float32)
    s = w2o.shape[0]
    sph16 = np.zeros((max(s, 1), ROW_COLS), np.float32)
    sph16[:, 13] = -1.0
    sph16[:s, 0:9] = w2o[:, :3, :3].reshape(s, 9)
    sph16[:s, 9:12] = w2o[:, :3, 3]
    sph16[:s, 12] = np.asarray(spheres.radius, np.float32)
    sph16[:s, 13] = np.where(np.asarray(spheres.prim) >= 0, 1.0, -1.0)
    return tris16, sph16


def device_bvh(bvh: FlatBVH, tris, spheres, device) -> DeviceBVH:
    tris16, sph16 = pack_rows(tris, spheres)

    def as_t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return DeviceBVH(as_t(bvh.bmin), as_t(bvh.bmax), as_t(bvh.hit), as_t(bvh.miss),
                     as_t(bvh.first), as_t(bvh.count), as_t(bvh.prim_refs), as_t(tris16),
                     as_t(sph16), int(bvh.n_tris), as_t(pack_nodes(bvh)))


# ---------------------------------------------------------------------------
# the plain traversal


def _slab_test(bmin, bmax, o, inv_d, neg, t_max):
    """bounds.rs:303-323 slab test. bmin/bmax: (N,3) gathered; o: (N,3);
    inv_d: (N,3); neg: (N,3) bool (d<0); t_max: (N,). The max / min over
    the axes propagate NaN, as the JAX package's reductions do."""
    near = torch.where(neg, bmax, bmin)
    far = torch.where(neg, bmin, bmax)
    t0 = (near - o) * inv_d
    t1 = (far - o) * inv_d * float(T_SCALE)
    tn = torch.maximum(t0[:, 0], torch.maximum(t0[:, 1], t0[:, 2]))
    tf = torch.minimum(t1[:, 0], torch.minimum(t1[:, 1], t1[:, 2]))
    return (tn <= tf) & (tn < t_max) & (tf > 0.0)


def _leaf_prim_test(bvh: DeviceBVH, ref, o, d, shear, t_max):
    """Test one primitive per ray: ref (n,) i32 prim_refs entries. Returns
    (t (n,), FLOAT_MAX where not ok; ok (n,) bool)."""
    is_tri = ref < bvh.n_tris
    t = torch.full(ref.shape, _FMAX, dtype=torch.float32, device=o.device)
    ok = torch.zeros(ref.shape, dtype=torch.bool, device=o.device)
    kz, sx, sy, sz = shear
    tri = torch.nonzero(is_tri).squeeze(1)
    if tri.numel():
        rows = bvh.tris16[ref[tri].long()]
        t_tri, _b, ok_tri = isect.watertight_core(
            o[tri], kz[tri], sx[tri], sy[tri], sz[tri], t_max[tri], rows[:, 0:3], rows[:, 3:6],
            rows[:, 6:9], with_bary=False)
        ok_tri = ok_tri & (rows[:, 9] > 0.0)
        t[tri], ok[tri] = torch.where(ok_tri, t_tri, _FMAX), ok_tri
    sph = torch.nonzero(~is_tri).squeeze(1)
    if sph.numel():
        rows = bvh.sph16[(ref[sph] - bvh.n_tris).long()]
        w2o = torch.zeros((rows.shape[0], 4, 4), dtype=torch.float32, device=o.device)
        w2o[:, :3, :3] = rows[:, 0:9].reshape(-1, 3, 3)
        o_obj = isect._mat3_vec(w2o, o[sph]) + rows[:, 9:12]
        d_obj = isect._mat3_vec(w2o, d[sph])
        t_s, ok_s = isect.sphere_quadratic(o_obj, d_obj, rows[:, 12], t_max[sph])
        ok_s = ok_s & (rows[:, 13] > 0.0)
        t[sph], ok[sph] = torch.where(ok_s, t_s, _FMAX), ok_s
    return t, ok


def bvh_traverse(bvh: DeviceBVH, o, d, t_max, any_hit: bool = False, stats: bool = False):
    """The plain traversal → (t: (N,) — t_max where there is no hit —,
    ref: (N,) i32 winning prim_refs entry or -1); with stats=True also the
    per-ray int32 counts (nodes visited, triangle tests, sphere tests) —
    the work of the walk, the input of its bound.

    The JAX package's lockstep loop, each iteration over the rays still
    walking (a ray's result does not depend on the others', so dropping the
    finished ones changes nothing). With any_hit=True a ray stops after the
    leaf of its first confirmed hit (shadow rays)."""
    N = o.shape[0]
    dev = o.device
    t_out = t_max.clone()
    ref_out = torch.full((N,), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros((3, N), dtype=torch.int32, device=dev)  # nodes, tri, sphere tests
    inv_d_all = 1.0 / torch.where(d == 0, float(Float(1e-30)), d)
    shear_all = isect.ray_shear(d)
    lane = torch.nonzero(t_max > 0).squeeze(1)  # dead lanes start at END
    ptr = torch.zeros(lane.shape, dtype=torch.int32, device=dev)
    k_last = bvh.prim_refs.shape[0] - 1
    while lane.numel():
        oo, dd, inv_d = o[lane], d[lane], inv_d_all[lane]
        shear = tuple(x[lane] for x in shear_all)
        t_best, ref_best = t_out[lane], ref_out[lane]
        p = ptr.long()
        if stats:
            counts[0, lane] += 1
        enter = _slab_test(bvh.bmin[p], bvh.bmax[p], oo, inv_d, dd < 0.0, t_best)
        first, count = bvh.first[p], bvh.count[p]
        is_leaf = (first >= 0) & enter
        for k in range(LEAF_SIZE):
            valid = torch.nonzero(is_leaf & (k < count)).squeeze(1)
            if valid.numel() == 0:
                break
            slot = torch.clamp(first[valid] + k, 0, k_last).long()
            ref = bvh.prim_refs[slot]
            if stats:
                is_tri = (ref < bvh.n_tris).to(torch.int32)
                counts[1, lane[valid]] += is_tri
                counts[2, lane[valid]] += 1 - is_tri
            t_k, ok_k = _leaf_prim_test(bvh, ref, oo[valid], dd[valid],
                                        tuple(x[valid] for x in shear), t_best[valid])
            better = ok_k & (t_k < t_best[valid])
            t_best[valid] = torch.where(better, t_k, t_best[valid])
            ref_best[valid] = torch.where(better, ref, ref_best[valid])
        nxt = torch.where(enter, bvh.hit[p], bvh.miss[p])
        if any_hit:
            nxt = torch.where(ref_best >= 0, -1, nxt)
        t_out[lane], ref_out[lane] = t_best, ref_best
        go = nxt >= 0
        lane, ptr = lane[go], nxt[go]
    return (t_out, ref_out, *counts) if stats else (t_out, ref_out)
