"""Closest-hit and any-hit traversal of the flat threaded BVH: the wrappers
of csrc/bvh_walk.cu. For tensors on the CPU they run the plain version
(ops/bvh.py bvh_traverse, the JAX package's lockstep loop); for CUDA
tensors they launch the kernel and raise if it cannot run — there is no
fallback from the card to the plain code or to another walk.

bvh_closest / bvh_any launch the live-ray walk: a pass over the lanes that
writes the dead lanes' outputs and lists the live ones on the device, then
one thread per live ray over the 32-byte node rows (DeviceBVH.nodes), on a
grid sized to the card (128 threads a block, all the blocks that fit).
Inputs are made contiguous and 16-byte aligned (a misaligned view is
copied); outputs are fresh allocations. The wrapper allocates the list and
its counter and never reads them: no host sync.

The kernels have no TPU counterpart: the JAX package's bvh_traverse
(curry_pbrt_tpu/ops/bvh.py:298) is a jnp while_loop, which the port as
eager PyTorch would run as hundreds of launches and one host-checked
`any(ptr >= 0)` per step. Launches are counted in
intersect_kernel.LAUNCHES: bvh_closest, bvh_any.

make_bvh_intersectors builds the renderer's intersector trio (render.py's
intersector="bvh") on bvh_closest / bvh_any.
"""

from __future__ import annotations

import torch

from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX
from curry_pbrt_tpu_torch.ops import intersect as isect
from curry_pbrt_tpu_torch.ops.bvh import NODE_COLS, DeviceBVH, bvh_traverse
from curry_pbrt_tpu_torch.ops.kernels.intersect_kernel import (
    _G2,
    _G3,
    _G5,
    T_SCALE,
    LAUNCHES,
    WARP,
    _aligned,
)


def _check(bvh: DeviceBVH, o, d, t_max):
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3) or t_max.shape != (n,):
        raise ValueError(f"rays must be o, d (N,3) and t_max (N,); got {o.shape}, {d.shape}, "
                         f"{t_max.shape}")
    if any(x.dtype != torch.float32 for x in (o, d, t_max, bvh.bmin, bvh.bmax, bvh.tris16,
                                               bvh.sph16, bvh.nodes)):
        raise TypeError("rays, node bounds, node rows and primitive rows must be float32")
    if any(x.dtype != torch.int32 for x in (bvh.hit, bvh.miss, bvh.first, bvh.count,
                                             bvh.prim_refs)):
        raise TypeError("node links, leaf ranges and prim_refs must be int32")
    if bvh.nodes.shape != (bvh.n_nodes, NODE_COLS):
        raise ValueError(f"node rows must be (M, {NODE_COLS}); got {tuple(bvh.nodes.shape)}")
    if any(x.device != o.device for x in (d, t_max, bvh.nodes) + tuple(bvh[:9])):
        raise ValueError("rays and BVH must be on one device")
    if o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no BVH traversal for device {o.device}")
    if o.device.type == "cuda" and n > 2**31 - 1 - WARP:
        raise ValueError(f"the kernels index rays with 32-bit ints; got {n} rays")


_CONSTS = [float(_G2), float(_G3), float(_G5), float(T_SCALE)]


def _call(entry: str, o, args) -> None:
    """Call one entry point of csrc/bvh_walk.cu on o's device and current
    stream; raises on a refused launch."""
    from curry_pbrt_tpu_torch.ops.kernels.build import load_library

    stream = torch.cuda.current_stream(o.device).cuda_stream
    if o.device.index == torch.cuda.current_device():
        err = getattr(load_library(), entry)(*args, stream)
    else:
        with torch.cuda.device(o.device):
            err = getattr(load_library(), entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")


def _launch_live(entry: str, counter: str, bvh: DeviceBVH, o, d, t_max, outs) -> None:
    """Launch the live-ray walk on CUDA tensors; counts the launch."""
    n = o.shape[0]
    if n == 0:
        return
    nodes = bvh.nodes
    if not nodes.is_contiguous() or nodes.data_ptr() % 32 != 0:
        raise ValueError("node rows must be contiguous and 32-byte aligned (device_bvh's are)")
    live = torch.empty(n, dtype=torch.int32, device=o.device)  # the live lanes' indices
    n_live = torch.zeros(1, dtype=torch.int32, device=o.device)  # their count
    keep = [_aligned(x) for x in (o, d, t_max)] + [nodes] + [
        _aligned(x) for x in (bvh.prim_refs, bvh.tris16, bvh.sph16)]
    args = [x.data_ptr() for x in keep] + [n, bvh.n_tris] + _CONSTS
    args += [live.data_ptr(), n_live.data_ptr()] + [x.data_ptr() for x in outs]
    # the scratch and `keep` may be freed on return: the caching allocator
    # reuses their memory only for work queued after this launch on the stream
    _call(entry, o, args)
    LAUNCHES[counter] += 1


def _closest_outputs(t_max):
    return torch.empty_like(t_max), torch.empty(t_max.shape, dtype=torch.int32,
                                                device=t_max.device)


def bvh_closest(bvh: DeviceBVH, o, d, t_max):
    """Closest hit → (t (N,) f32 — t_max where there is no hit —, ref (N,)
    int32 winning prim_refs entry or -1). CPU tensors → the plain version;
    CUDA tensors → the live-ray walk."""
    _check(bvh, o, d, t_max)
    if o.device.type == "cpu":
        return bvh_traverse(bvh, o, d, t_max)
    t, ref = _closest_outputs(t_max)
    _launch_live("curry_bvh_closest_hit", "bvh_closest", bvh, o, d, t_max, [t, ref])
    return t, ref


def bvh_any(bvh: DeviceBVH, o, d, t_max):
    """Any hit within t_max → (N,) bool (shadow rays). CPU tensors → the
    plain version; CUDA tensors → the live-ray walk."""
    _check(bvh, o, d, t_max)
    if o.device.type == "cpu":
        return bvh_traverse(bvh, o, d, t_max, any_hit=True)[1] >= 0
    hit = torch.empty(t_max.shape, dtype=torch.bool, device=o.device)
    _launch_live("curry_bvh_any_hit", "bvh_any", bvh, o, d, t_max, [hit])
    return hit


def make_bvh_intersectors(bvh: DeviceBVH, tris, sph):
    """Returns (intersect, predicate, intersect_tprim) callables matching
    the brute API, over bvh_closest / bvh_any (the live-ray walk on the
    card, ops/bvh.py's plain version on the CPU). tris / sph: the scene's
    arrays as tensors on the BVH's device."""
    n_tris = bvh.n_tris

    def split(ref):
        is_tri = (ref >= 0) & (ref < n_tris)
        is_sph = ref >= n_tris
        tri_idx = torch.clamp(ref, 0, max(tris.count - 1, 0)).long()
        sph_idx = torch.clamp(ref - n_tris, 0, max(sph.count - 1, 0)).long()
        return is_tri, is_sph, tri_idx, sph_idx

    def intersect(o, d, t_max) -> isect.Hit:
        t, ref = bvh_closest(bvh, o, d, t_max)
        N = o.shape[0]
        is_tri, is_sph, tri_idx, sph_idx = split(ref)
        z3 = torch.zeros((N, 3), dtype=torch.float32, device=o.device)
        p, n, perr = z3, z3, z3
        uv = torch.zeros((N, 2), dtype=torch.float32, device=o.device)
        prim = torch.full((N,), -1, dtype=torch.int32, device=o.device)
        if tris.count > 0:
            # winner-only re-test + attributes, single vertex gather
            tp, tn, tuv, terr = isect.triangle_winner_attributes(o, d, t_max, tri_idx, tris)
            m = is_tri[:, None]
            p, n = torch.where(m, tp, p), torch.where(m, tn, n)
            uv, perr = torch.where(m, tuv, uv), torch.where(m, terr, perr)
            prim = torch.where(is_tri, tris.prim[tri_idx], prim)
        if sph.count > 0:
            sp, sn, suv, serr = isect.sphere_hit_attributes(sph_idx, t, o, d, sph)
            m = is_sph[:, None]
            p, n = torch.where(m, sp, p), torch.where(m, sn, n)
            uv, perr = torch.where(m, suv, uv), torch.where(m, serr, perr)
            prim = torch.where(is_sph, sph.prim[sph_idx], prim)
        return isect.Hit(t, prim, p, n, uv, perr)

    def predicate(o, d, t_max):
        return bvh_any(bvh, o, d, t_max)

    def intersect_tprim(o, d, t_max):
        """(t, prim) only — no attribute reconstruction (NEE MIS leg)."""
        t, ref = bvh_closest(bvh, o, d, t_max)
        is_tri, is_sph, tri_idx, sph_idx = split(ref)
        prim = torch.full(o.shape[:1], -1, dtype=torch.int32, device=o.device)
        if tris.count > 0:
            prim = torch.where(is_tri, tris.prim[tri_idx], prim)
        if sph.count > 0:
            prim = torch.where(is_sph, sph.prim[sph_idx], prim)
        return torch.where(ref >= 0, t, float(FLOAT_MAX)), prim

    def detached(fn):
        """Geometry gradients stop at the traversal, as on the other paths."""
        return lambda o, d, t_max: fn(o.detach(), d.detach(), t_max.detach())

    return detached(intersect), detached(predicate), detached(intersect_tprim)
