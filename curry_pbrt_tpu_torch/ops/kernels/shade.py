"""The path continuation on the card: the wrapper of csrc/shade.cu, whose
kernel computes models/integrators.continue_path_plain, the tail of one
bounce of path_trace.

It replaces no Pallas kernel: the JAX package's continuation is jnp that
XLA fuses. In the port it was some hundreds of full-width PyTorch ops a
bounce, each (N, 3) temporary written to device memory and read back, every
family's whole bsdf_sample run for every lane and then selected by
material, and dead lanes computed like the rest. `continue_kernel` does one
lane a thread: the shading frame, the lane's own family's BSDF sample,
to_world, the throughput, the spawned ray, the path state's update and
Russian roulette, written to fresh tensors. Each lane reads only its own
family's lobe constants: the plan's `shade_slot` maps a material id to the
slot of its family among all the plan's families (ctx.families, delta-only
ones included), and each slot's lobe tensors go to the kernel as pointers
and strides, so an expanded constant (materials.eval_texref's broadcast) is
read with stride 0 and never copied.

The choice between the kernel and the plain version belongs to
integrators.continue_path, beside that plain version (continue_path_plain):
it calls `continuation` where integrators.continuation_refusal finds nothing
against it: lanes on a CUDA card, autograd off, and a plan
(ShadeContext.shade_refusal, worked out once when the plan is built) of at
most shading.MAX_FAMS families (delta-only ones included) of at most
shading.MAX_LOBES lobes of the kinds in KINDS.
`continuation` launches the kernel or raises; it never falls back. Launches
are counted in intersect_kernel.LAUNCHES["shade_continue"] (one a call);
`bound_bytes` gives the least bytes the kernel moves for a call, its
roofline.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from curry_pbrt_tpu_torch.ops.kernels import shading as SH
from curry_pbrt_tpu_torch.ops.kernels.intersect_kernel import LAUNCHES

KINDS = tuple(SH.KINDS)  # lobe kinds the kernel implements (csrc/shade.cu)
# each kind's lobe tensors the kernel reads (fresnel_noop: no eta)
_READS = {"lambert_r": ("albedo",), "ggx_r": ("albedo", "alpha_x", "alpha_y", "eta_a", "eta_b"),
          "spec_r": ("albedo", "eta_a", "eta_b"), "spec_t": ("albedo", "eta_a", "eta_b")}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class _ShadeFam(ctypes.Structure):
    _fields_ = [("n_nd", _I), ("n_d", _I), ("p_nb", _F), ("p_d", _F),
                ("lobe", SH.Lobe * SH.MAX_LOBES)]


class _ContinueArgs(ctypes.Structure):
    _fields_ = ([("n", _I), ("n_fams", _I), ("roulette", _I), ("pad", _I), ("k", SH.Consts)]
                + [(f, _P) for f in ("active", "specular", "mat_ids", "fam_slot")]
                + [(f, SH.Rows3) for f in ("p", "nrm", "perr", "o", "d", "beta")]
                + [(f, SH.Rows1) for f in ("u_bucket", "u_extra", "u_rr")]
                + [(f, _P) for f in ("o_out", "d_out", "beta_out", "active_out", "specular_out")]
                + [("fam", _ShadeFam * SH.MAX_FAMS)])


@functools.lru_cache(maxsize=None)
def _library():
    from curry_pbrt_tpu_torch.ops.kernels.build import load_library

    lib = load_library()
    size = lib.curry_shade_continue_args_size()
    if size != ctypes.sizeof(_ContinueArgs):
        raise RuntimeError(f"_ContinueArgs is {ctypes.sizeof(_ContinueArgs)} bytes here and "
                           f"{size} in csrc/shade.cu: the layouts disagree")
    return lib


def _reads(lobe):
    """The names of the tensors of `lobe` the kernel reads."""
    return _READS[lobe.kind][:1] if lobe.fresnel_noop and lobe.is_delta else _READS[lobe.kind]


def _fam_args(lobes, n: int) -> _ShadeFam:
    nd = [lobe for lobe in lobes if not lobe.is_delta]
    dl = [lobe for lobe in lobes if lobe.is_delta]
    fam = _ShadeFam(len(nd), len(dl))
    if nd and dl:  # bsdf_sample's bucket probabilities, rounded in float32
        p_nb = np.float32(len(nd)) / np.float32(len(nd) + len(dl))
        fam.p_nb, fam.p_d = float(p_nb), float(np.float32(1.0) - p_nb)
    for j, lobe in enumerate(nd + dl):
        fam.lobe[j] = SH.lobe(lobe, n, _reads(lobe)[1:])
    return fam


def continuation(ctx, hit, mat_ids, o, d, beta, specular, active, frame, u, fam_lobes, bounce):
    """continue_path's (o, d, beta, specular, active) through the kernel.
    Takes continue_path's arguments (`frame` unused: the kernel builds it
    from hit.n); raises for lanes off the card or a plan the kernel does not
    implement."""
    if hit.p.device.type != "cuda":
        raise ValueError(f"the continuation kernel takes CUDA tensors; got {hit.p.device}")
    if ctx.shade_refusal is not None:
        raise ValueError(f"the continuation kernel does not implement this plan: "
                         f"{ctx.shade_refusal}")
    return continue_kernel(ctx, hit, mat_ids, o, d, beta, specular, active, u, fam_lobes,
                           bounce, _library(), torch.cuda.current_stream(hit.p.device).cuda_stream)


def continue_kernel(ctx, hit, mat_ids, o, d, beta, specular, active, u, fam_lobes, bounce, lib,
                    stream):
    """continue_kernel through `lib` on `stream`: the outputs allocated here
    (never the caller's tensors), the argument struct filled from the
    tensors' pointers and strides → (o, d, beta, specular, active)."""
    n = hit.p.shape[0]
    dev = hit.p.device
    active = active.to(torch.bool).contiguous()
    specular = specular.to(torch.bool).contiguous()
    mat_ids = mat_ids.to(torch.int32).contiguous()
    rays = torch.empty((3, n, 3), dtype=torch.float32, device=dev)  # o, d, beta
    flags = torch.empty((2, n), dtype=torch.bool, device=dev)  # specular, active

    a = _ContinueArgs()
    a.n, a.n_fams, a.roulette, a.k = n, len(ctx.families), int(bounce > 3), SH.consts(0)
    a.active, a.specular = active.data_ptr(), specular.data_ptr()
    a.mat_ids, a.fam_slot = mat_ids.data_ptr(), ctx.shade_slot.data_ptr()
    a.p, a.nrm, a.perr, a.o, a.d, a.beta = (SH.rows3(t, n) for t in (hit.p, hit.n, hit.p_error,
                                                                       o, d, beta))
    a.u_bucket, a.u_extra, a.u_rr = (SH.rows1(u[k], n)
                                     for k in ("bsdf_bucket", "bsdf_extra", "rr"))
    a.o_out, a.d_out, a.beta_out = (rays[j].data_ptr() for j in range(3))
    a.specular_out, a.active_out = flags[0].data_ptr(), flags[1].data_ptr()
    lobes_of = {id(fam): lobes for fam, lobes in fam_lobes}
    for s, fam in enumerate(ctx.families):
        a.fam[s] = _fam_args(lobes_of[id(fam)], n)
    err = lib.curry_shade_continue(ctypes.addressof(a), stream)
    # the inputs may be freed now: the caching allocator reuses their memory
    # only for work queued after this launch on this stream
    if err != 0:
        raise RuntimeError(f"curry_shade_continue kernel launch failed: CUDA error {err}")
    LAUNCHES["shade_continue"] += 1
    return rays[0], rays[1], rays[2], flags[0], flags[1]


def bound_bytes(mat_ids, fam_lobes, active, bounce) -> int:
    """The least bytes continue_kernel moves for one call, each byte read or
    written once. Every lane reads its active flag and writes o, d, beta,
    specular and active (38 B). A lane that is not active reads its o, d,
    beta and specular (37 B). An active lane reads its material id, hit
    (p, n, p_error), d, beta, the bucket and extra sampler values and, past
    bounce 3, the roulette value (72 or 76 B), and the lobe tensors that are
    not broadcast of the cheapest choice its family's sample can make: one
    non-delta lobe, or every delta lobe (0 for a family of broadcast
    constants); its old o and specular, which it reads only when the path
    ends there, are not counted. Reads the lanes back: for tools and tests,
    never on the render path."""
    n, live = active.shape[0], int(active.sum())
    lobe = 0
    for fam, lobes in fam_lobes:
        members = int(fam.mask(mat_ids)[active].sum())
        cost = [sum(t[0].numel() * 4 for t in {t.data_ptr(): t for t in
                                                (getattr(lb, name) for name in _reads(lb))
                                                if t.stride(0) != 0}.values())
                for lb in lobes]
        nd = [c for c, lb in zip(cost, lobes) if not lb.is_delta]
        dl = [c for c, lb in zip(cost, lobes) if lb.is_delta]
        choices = ([min(nd)] if nd else []) + ([sum(dl)] if dl else [])
        lobe += members * min(choices, default=0)
    return n * 39 + (n - live) * 37 + live * (72 + 4 * (bounce > 3)) + lobe
