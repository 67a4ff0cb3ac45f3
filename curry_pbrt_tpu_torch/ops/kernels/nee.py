"""Next-event estimation on the card: the wrapper of csrc/nee.cu, whose two
kernels compute models/integrators.uniform_sample_one_light around its
shadow and MIS traversals.

It replaces no Pallas kernel: the JAX package's uniform_sample_one_light is
jnp that XLA fuses. In the port it was some hundreds of full-width PyTorch
ops a bounce, each (N, 3) temporary written to device memory and read back,
every non-delta family's lobes evaluated and sampled for every lane, and
discarded lanes computed like the rest. The kernels do one lane a thread:
`nee_sample_kernel` writes the shadow ray, the MIS ray and a small carry;
the plan's own `predicate` (K2) and `intersect_tprim` (slim K1) walk them,
unchanged; `nee_finish_kernel` turns the occlusion bit and the MIS hit into
the (N, 3) radiance. Each lane reads only its own family's lobe constants:
the plan's `nee_slot` maps a material id to its family's slot, and each
slot's lobe tensors go to the kernel as pointers and strides, so an
expanded constant (materials.eval_texref's broadcast) is read with stride
0 and never copied.

The choice between the kernels and the plain version belongs to
integrators.uniform_sample_one_light, beside that plain version
(uniform_sample_one_light_plain): it calls `nee` where
integrators.nee_refusal finds nothing against it: lanes on a CUDA card,
autograd off, and a plan (ShadeContext.nee_refusal, worked out once when
the plan is built) with no infinite light, only area-triangle lights and
at most shading.MAX_FAMS non-delta families of at most shading.MAX_LOBES
lobes of the kinds in KINDS. `nee` launches the kernels or raises; it never
falls back. Launches are counted in intersect_kernel.LAUNCHES["nee_sample"] and
["nee_finish"] (one each a call); `bound_bytes` gives the least bytes the
two kernels move for a call, their roofline.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from curry_pbrt_tpu_torch.ops.kernels import shading as SH
from curry_pbrt_tpu_torch.ops.kernels.intersect_kernel import LAUNCHES

KINDS = ("lambert_r", "ggx_r")  # lobe kinds the kernels implement (csrc/nee.cu)

_P, _I = ctypes.c_void_p, ctypes.c_int


class _Fam(ctypes.Structure):
    _fields_ = [("n_lobes", _I), ("pad", _I), ("lobe", SH.Lobe * SH.MAX_LOBES)]


class _SampleArgs(ctypes.Structure):
    _fields_ = ([("n", _I), ("n_fams", _I), ("k", SH.Consts)]
                + [(f, _P) for f in ("mask", "mat_ids", "fam_slot")]
                + [(f, SH.Rows3) for f in ("p", "nrm", "perr", "wo")]
                + [(f, SH.Rows1) for f in ("u_pick", "u_light0", "u_light1", "u_nee0", "u_nee1")]
                + [(f, _P) for f in ("light_L", "tri_p0", "tri_p1", "tri_p2", "area", "vis_o",
                                     "vis_d", "vis_t", "o2", "wi2", "t2", "carry", "light_idx",
                                     "flags")]
                + [("fam", _Fam * SH.MAX_FAMS)])


class _FinishArgs(ctypes.Structure):
    _fields_ = ([("n", _I), ("k", SH.Consts)]
                + [(f, _P) for f in ("flags", "occluded", "hit_t", "hit_prim", "prim_light")]
                + [("p", SH.Rows3)]
                + [(f, _P) for f in ("o2", "wi2", "carry", "light_idx", "light_L", "tri_p0",
                                     "tri_p1", "tri_p2", "area", "out")])


@functools.lru_cache(maxsize=None)
def _library():
    from curry_pbrt_tpu_torch.ops.kernels.build import load_library

    lib = load_library()
    for struct, fn in ((_SampleArgs, lib.curry_nee_sample_args_size),
                       (_FinishArgs, lib.curry_nee_finish_args_size)):
        if fn() != ctypes.sizeof(struct):
            raise RuntimeError(f"{struct.__name__} is {ctypes.sizeof(struct)} bytes here and "
                               f"{fn()} in csrc/nee.cu: the layouts disagree")
    return lib


def _fam_args(lobes, n: int) -> _Fam:
    nd = [lobe for lobe in lobes if not lobe.is_delta]
    fam = _Fam(len(nd), 0)
    for j, lobe in enumerate(nd):
        fam.lobe[j] = SH.lobe(lobe, n, ("alpha_x", "alpha_y", "eta_a", "eta_b")
                              if lobe.kind == "ggx_r" else ())
    return fam


def nee(ctx, params, hit, mat_ids, wo, frame, u, fam_lobes, mask):
    """uniform_sample_one_light's (N, 3) radiance, already multiplied by
    the light count, through the two kernels around the plan's shadow and
    MIS walks. Takes uniform_sample_one_light's arguments (`frame` unused:
    the kernel builds it from hit.n); raises for lanes off the card or a
    plan the kernels do not implement."""
    if hit.p.device.type != "cuda":
        raise ValueError(f"the NEE kernels take CUDA tensors; got {hit.p.device}")
    if ctx.nee_refusal is not None:
        raise ValueError(f"the NEE kernels do not implement this plan: {ctx.nee_refusal}")
    return nee_kernels(ctx, params["light_L"], hit, mat_ids, wo, u, fam_lobes, mask, _library(),
                       torch.cuda.current_stream(hit.p.device).cuda_stream)


class Sampled(NamedTuple):
    """nee_sample_kernel's outputs: the two walks' rays and the finish's
    carry."""

    rays: torch.Tensor  # (4, N, 3): the shadow ray's o, d, the MIS ray's o, d
    tmax: torch.Tensor  # (2, N): their t_max (0 where the mask is unset)
    carry: torch.Tensor  # (N, 8): ld_light (3), f2 (3), f2_pdf, cos2
    light_idx: torch.Tensor  # (N,) int32
    flags: torch.Tensor  # (N,) uint8: 1 the light strategy's, 2 the BSDF strategy's ok
    args: _SampleArgs


def nee_sample(ctx, light_L, hit, mat_ids, wo, u, fam_lobes, mask, lib, stream) -> Sampled:
    """nee_sample_kernel through `lib` on `stream`: the outputs allocated
    here, the argument struct filled from the tensors' pointers and
    strides."""
    n = hit.p.shape[0]
    dev = hit.p.device
    dl = ctx.dev_lights
    tables = [light_L, dl.tri_p0, dl.tri_p1, dl.tri_p2, dl.area]
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in tables):
        raise ValueError("the NEE kernels take the light table and light_L as contiguous "
                         "float32 tensors")
    mask = mask.to(torch.bool).contiguous()
    mat_ids = mat_ids.to(torch.int32).contiguous()
    out = Sampled(torch.empty((4, n, 3), dtype=torch.float32, device=dev),
                  torch.empty((2, n), dtype=torch.float32, device=dev),
                  torch.empty((n, 8), dtype=torch.float32, device=dev),
                  torch.empty((n,), dtype=torch.int32, device=dev),
                  torch.empty((n,), dtype=torch.uint8, device=dev), _SampleArgs())

    slots = ctx.nee_fams
    lobes_of = {id(fam): lobes for fam, lobes in fam_lobes}
    a = out.args
    a.n, a.n_fams, a.k = n, len(slots), SH.consts(ctx.n_lights)
    a.mask, a.mat_ids, a.fam_slot = mask.data_ptr(), mat_ids.data_ptr(), ctx.nee_slot.data_ptr()
    a.p, a.nrm, a.perr, a.wo = (SH.rows3(t, n) for t in (hit.p, hit.n, hit.p_error, wo))
    us = [u[k] for k in ("light_pick", "light_u", "light_v", "nee_u", "nee_v")]
    a.u_pick, a.u_light0, a.u_light1, a.u_nee0, a.u_nee1 = (SH.rows1(t, n) for t in us)
    a.light_L, a.tri_p0, a.tri_p1, a.tri_p2, a.area = (t.data_ptr() for t in tables)
    a.vis_o, a.vis_d, a.o2, a.wi2 = (out.rays[j].data_ptr() for j in range(4))
    a.vis_t, a.t2 = out.tmax[0].data_ptr(), out.tmax[1].data_ptr()
    a.carry, a.light_idx, a.flags = (out.carry.data_ptr(), out.light_idx.data_ptr(),
                                     out.flags.data_ptr())
    for s, fam in enumerate(slots):
        a.fam[s] = _fam_args(lobes_of[id(fam)], n)
    err = lib.curry_nee_sample(ctypes.addressof(a), stream)
    # mask and mat_ids may be freed now: the caching allocator reuses their
    # memory only for work queued after this launch on this stream
    if err != 0:
        raise RuntimeError(f"curry_nee_sample kernel launch failed: CUDA error {err}")
    LAUNCHES["nee_sample"] += 1
    return out


def nee_finish(ctx, s: Sampled, occluded, hit_t, hit_prim, lib, stream):
    """nee_finish_kernel through `lib` on `stream` over the shadow walk's
    occlusion bits and the MIS walk's (t, prim) → (N, 3) radiance."""
    occluded = occluded.to(torch.bool).contiguous()
    hit_t = hit_t.to(torch.float32).contiguous()
    hit_prim = hit_prim.to(torch.int32).contiguous()
    a = s.args
    out = torch.empty((a.n, 3), dtype=torch.float32, device=s.rays.device)
    b = _FinishArgs()
    b.n, b.k = a.n, a.k
    b.flags, b.occluded = a.flags, occluded.data_ptr()
    b.hit_t, b.hit_prim = hit_t.data_ptr(), hit_prim.data_ptr()
    b.prim_light = ctx.prim_light.data_ptr()
    b.p = a.p
    b.o2, b.wi2, b.carry, b.light_idx = a.o2, a.wi2, a.carry, a.light_idx
    b.light_L, b.tri_p0, b.tri_p1, b.tri_p2, b.area = (a.light_L, a.tri_p0, a.tri_p1, a.tri_p2,
                                                       a.area)
    b.out = out.data_ptr()
    err = lib.curry_nee_finish(ctypes.addressof(b), stream)
    if err != 0:
        raise RuntimeError(f"curry_nee_finish kernel launch failed: CUDA error {err}")
    LAUNCHES["nee_finish"] += 1
    return out


def nee_kernels(ctx, light_L, hit, mat_ids, wo, u, fam_lobes, mask, lib, stream):
    """The two kernels through `lib` on `stream` around the plan's shadow
    walk (ctx.predicate) and MIS walk (ctx.intersect_tprim)."""
    s = nee_sample(ctx, light_L, hit, mat_ids, wo, u, fam_lobes, mask, lib, stream)
    occluded = ctx.predicate(s.rays[0], s.rays[1], s.tmax[0])
    hit_t, hit_prim = ctx.intersect_tprim(s.rays[2], s.rays[3], s.tmax[1])
    return nee_finish(ctx, s, occluded, hit_t, hit_prim, lib, stream)


def bound_bytes(mat_ids, fam_lobes, mask, flags):
    """(sample, finish): the least bytes nee_sample_kernel and
    nee_finish_kernel move for one call, each byte read or written once.
    A consumed lane (`mask`) reads its hit, wo, five sampler values, its
    material id and mask (73 B) and its lobe tensors that are not broadcast,
    and writes two rays, two t_max, the carry, the light index and the flags
    (93 B); any other lane reads its mask and writes zero rays, t_max and
    flags (58 B). The finish reads the flags and writes 12 B a lane; a lane
    whose light strategy counts (`flags`, nee_sample's) reads its occlusion
    bit and its term (13 B), one whose BSDF strategy counts its MIS prim and
    light index (8 B; the lanes whose MIS ray hits the chosen light read
    60 B more, not counted here). Reads the lanes back: for tools and
    tests, never on the render path."""
    n, live = mask.shape[0], int(mask.sum())
    lobe = 0
    for fam, lobes in fam_lobes:
        members = int(fam.mask(mat_ids)[mask].sum())
        for lb in lobes:
            for t in (lb.albedo, lb.alpha_x, lb.alpha_y, lb.eta_a, lb.eta_b):
                if t is not None and t.stride(0) != 0 and not lb.is_delta:
                    lobe += members * t[0].numel() * 4
    light_ok = int(((flags & 1) != 0).sum())
    bsdf_ok = int(((flags & 2) != 0).sum())
    return live * (73 + 93) + lobe + (n - live) * 58, n * 13 + light_ok * 13 + bsdf_ok * 8
