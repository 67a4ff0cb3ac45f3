"""Wavefront integrators: MIS-NEE path tracing and direct lighting
(counterpart of the JAX package's models/integrators.py).

The whole ray batch lives in SoA tensors; a fixed-depth bounce loop runs
over fixed-shape tensors with active-lane masks:

    for bounce in 0..max_depth:
        closest hit → emission (bounce 0 / specular chains)
        → NEE (pick light, shadow ray, MIS; + BSDF-strategy leg)
        → continuation: BSDF sample → spawn → Russian roulette (mask+reweight)
    final bounce: (t, prim) hit → emission

The JAX package runs the bounces as a `lax.scan`; here it is a Python loop
whose body never reads a value back to the host, so the host only enqueues
work. Every lane consumes the same statically assigned Halton dimensions per
bounce (8: light pick, light 2D, NEE-BSDF 2D, BSDF bucket + extra, RR), so
images match the JAX package sample for sample.

Inside a render chunk, `trace.stage` marks where each stage of the device
work starts (utils/trace): sample, intersect, shade, nee.

Algorithm mapping to the reference:
  uniform_sample_one_light ← integrator/mod.rs:13-97
  path_trace               ← integrator/path.rs:13-66 (emission gating on
      bounce-0/specular, NEE gating on is_all_delta, RR after bounce 3 with
      q = max(0.05, 1−β.y), throughput update β·f·|cosθ|/pdf)
  direct_light_trace       ← integrator/direct_light.rs (NEE at each hit +
      delta recursion; the reference's per-ray branch enumeration becomes a
      luminance-weighted stochastic single branch, as in the JAX package)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX
from curry_pbrt_tpu_torch.models import lights as LT
from curry_pbrt_tpu_torch.models.materials import CompiledMaterial, MaterialFamily, lobe_kinds
from curry_pbrt_tpu_torch.ops import bsdf as B
from curry_pbrt_tpu_torch.ops import math as m
from curry_pbrt_tpu_torch.ops.halton import HaltonConfig, halton_sample
from curry_pbrt_tpu_torch.ops.intersect import Hit, offset_point_by_error
from curry_pbrt_tpu_torch.ops.kernels import nee as NK
from curry_pbrt_tpu_torch.ops.kernels import shade as SK
from curry_pbrt_tpu_torch.ops.kernels import shading as SH
from curry_pbrt_tpu_torch.utils import trace

DIMS_PER_BOUNCE = 8
(D_LIGHT_PICK, D_LIGHT_U, D_LIGHT_V, D_NEE_U, D_NEE_V, D_BSDF_BUCKET,
 D_BSDF_EXTRA, D_RR) = range(DIMS_PER_BOUNCE)
_U_KEYS = ("light_pick", "light_u", "light_v", "nee_u", "nee_v",
           "bsdf_bucket", "bsdf_extra", "rr")
_FMAX = float(FLOAT_MAX)


@dataclass
class ShadeContext:
    """Static shading info for one device."""

    materials: List[CompiledMaterial]  # only instances actually referenced
    families: List[MaterialFamily]  # shading dispatch groups over `materials`
    registry: dict  # named materials (for mix)
    lights: LT.LightArrays  # host table (decides static branches)
    dev_lights: LT.LightArrays  # the same table as device tensors
    envs: List[LT.EnvMap]  # one per infinite light (lights.env_id indexes), on the device
    n_lights: int
    mat_is_all_delta: torch.Tensor  # (M_total,) bool, indexed by mat_id
    intersect: Callable  # (o, d, t_max) -> Hit
    predicate: Callable  # (o, d, t_max) -> (N,) bool
    intersect_tprim: Callable  # (o, d, t_max) -> (t, prim) — slim MIS-leg path
    prim_mat: torch.Tensor  # (P,) i32
    prim_light: torch.Tensor  # (P,) i32
    nee_slot: torch.Tensor  # (M_total + 1,) i32 by mat_id + 1: non-delta family slot, -1 none
    nee_fams: List[MaterialFamily]  # the non-delta families, by slot (csrc/nee.cu's slots)
    nee_refusal: Optional[str]  # why the NEE kernels do not implement this plan; None: they do
    shade_slot: torch.Tensor  # (M_total + 1,) i32 by mat_id + 1: slot in `families`, -1 none
    shade_refusal: Optional[str]  # why the continuation kernel does not implement this plan


def _shading_frame(n):
    """BSDF::new with sn == n (bxdf/mod.rs:83-97): local +z is the geometric
    normal."""
    x, y = m.coordinate_system(n)
    return x, y, n


def build_family_lobes(ctx: ShadeContext, mat_ids, uv, params):
    """Evaluate every family's lobe stack once per bounce (shared by
    shade_eval, the NEE BSDF sample and the continuation sample)."""
    return [(fam, fam.make_lobes(uv, params, ctx.registry, mat_ids)) for fam in ctx.families]


def _nondelta_fams(ctx, fam_lobes):
    return [
        (fam, lobes)
        for fam, lobes in fam_lobes
        if not all(k in B.DELTA_KINDS for k in lobe_kinds(fam.rep, ctx.registry))
    ]


def _zeros(n, *tail, dtype=torch.float32, like):
    return torch.zeros((n,) + tail, dtype=dtype, device=like.device)


def shade_eval(ctx: ShadeContext, fam_lobes, mat_ids, wo_l, wi_l):
    """no_delta_f_pdf across material families → (f, pdf, present)."""
    N = wo_l.shape[0]
    f, pdf = _zeros(N, 3, like=wo_l), _zeros(N, like=wo_l)
    present = _zeros(N, dtype=torch.bool, like=wo_l)
    for fam, lobes in _nondelta_fams(ctx, fam_lobes):
        mf, mp, mpres = B.bsdf_eval_pdf(lobes, wo_l, wi_l)
        sel = fam.mask(mat_ids)
        f = torch.where(sel[:, None], mf, f)
        pdf = torch.where(sel, mp, pdf)
        present = torch.where(sel, mpres, present)
    return f, pdf, present


def shade_sample_nondelta(ctx: ShadeContext, fam_lobes, mat_ids, wo_l, u_pick, u2):
    """sample_no_delta_f across families → (wi_l, f, pdf, present)."""
    N = wo_l.shape[0]
    wi, f, pdf = _zeros(N, 3, like=wo_l), _zeros(N, 3, like=wo_l), _zeros(N, like=wo_l)
    present = _zeros(N, dtype=torch.bool, like=wo_l)
    for fam, lobes in _nondelta_fams(ctx, fam_lobes):
        mwi, mf, mp, mpres = B.bsdf_sample_nondelta(lobes, wo_l, u_pick, u2)
        sel = fam.mask(mat_ids)
        wi = torch.where(sel[:, None], mwi, wi)
        f = torch.where(sel[:, None], mf, f)
        pdf = torch.where(sel, mp, pdf)
        present = torch.where(sel, mpres, present)
    return wi, f, pdf, present


def shade_sample(ctx: ShadeContext, fam_lobes, mat_ids, wo_l, u_bucket, u_extra):
    """sample_f across families → (wi_l, f, pdf, present, is_delta)."""
    N = wo_l.shape[0]
    wi, f, pdf = _zeros(N, 3, like=wo_l), _zeros(N, 3, like=wo_l), _zeros(N, like=wo_l)
    present = _zeros(N, dtype=torch.bool, like=wo_l)
    is_delta = _zeros(N, dtype=torch.bool, like=wo_l)
    for fam, lobes in fam_lobes:
        mwi, mf, mp, mpres, mdelta = B.bsdf_sample(lobes, wo_l, u_bucket, u_extra)
        sel = fam.mask(mat_ids)
        wi = torch.where(sel[:, None], mwi, wi)
        f = torch.where(sel[:, None], mf, f)
        pdf = torch.where(sel, mp, pdf)
        present = torch.where(sel, mpres, present)
        is_delta = torch.where(sel, mdelta, is_delta)
    return wi, f, pdf, present, is_delta


def nondelta_families(families: List[MaterialFamily], registry) -> List[MaterialFamily]:
    """The families with a non-delta lobe, in the order shade_eval visits
    them: the NEE kernels' family slots."""
    return [fam for fam in families
            if not all(k in B.DELTA_KINDS for k in lobe_kinds(fam.rep, registry))]


def family_slot_table(slots: List[MaterialFamily], n_mats: int) -> np.ndarray:
    """(n_mats + 1,) int32 by material id + 1 (slot 0: the miss id -1): the
    slot in `slots` of the family the material belongs to, -1 for none."""
    table = np.full((n_mats + 1,), -1, np.int32)
    for slot, fam in enumerate(slots):
        table[np.asarray(fam.member_ids, np.int64) + 1] = slot
    return table


def nee_plan_refusal(lights: LT.LightArrays, n_envs: int, slots: List[MaterialFamily],
                     registry) -> Optional[str]:
    """Why the NEE kernels (ops/kernels/nee.py) do not implement a plan's
    lights or lobes, None where they do. `slots`: nondelta_families. Read
    from the host tables once, when the plan's ShadeContext is built."""
    if n_envs:
        return "an infinite light"
    types = LT.types_present(lights.type_id)
    if not types:
        return "no light"
    if types - {LT.TYPE_AREA_TRI}:
        return f"a light of type {min(types - {LT.TYPE_AREA_TRI})} (the kernels sample area " \
               f"triangles)"
    return _slots_refusal(slots, registry, NK.KINDS, with_delta=False)


def shade_plan_refusal(families: List[MaterialFamily], registry) -> Optional[str]:
    """Why the continuation kernel (ops/kernels/shade.py) does not implement
    a plan's lobes, None where it does. Its slots are all of `families`.
    Read from the host tables once, when the plan's ShadeContext is built."""
    return _slots_refusal(families, registry, SK.KINDS, with_delta=True)


def _slots_refusal(slots: List[MaterialFamily], registry, kinds_done,
                   with_delta: bool) -> Optional[str]:
    """Why a shading kernel's family slots (ops/kernels/shading.py) cannot
    hold `slots`: too many families, too many lobes in one, or a lobe kind
    outside `kinds_done`. `with_delta`: whether delta lobes take slots."""
    what = "" if with_delta else "non-delta "
    if len(slots) > SH.MAX_FAMS:
        return f"{len(slots)} {what}families (at most {SH.MAX_FAMS})"
    for fam in slots:
        kinds = [k for k in lobe_kinds(fam.rep, registry)
                 if with_delta or k not in B.DELTA_KINDS]
        if len(kinds) > SH.MAX_LOBES:
            return f"{len(kinds)} {what}lobes in a family (at most {SH.MAX_LOBES})"
        lacking = [k for k in kinds if k not in kinds_done]
        if lacking:
            return f"lobe kind {lacking[0]}"
    return None


def _lane_refusal(device) -> Optional[str]:
    """Why no kernel of csrc/ runs for lanes on `device` in this autograd
    mode, None where one may."""
    if torch.device(device).type != "cuda":
        return "lanes not on a CUDA card"
    if torch.is_grad_enabled():
        return "autograd on"
    return None


def nee_refusal(ctx: ShadeContext, device) -> Optional[str]:
    """Why uniform_sample_one_light runs the plain path for lanes on
    `device`, None where it runs the kernels: lanes off the card, autograd
    on, or the plan's own reason (ctx.nee_refusal). Reads no tensor, so a
    chunk program can record the choice."""
    return _lane_refusal(device) or ctx.nee_refusal


def continuation_refusal(ctx: ShadeContext, device) -> Optional[str]:
    """Why continue_path runs the plain path for lanes on `device`, None
    where it runs the kernel: lanes off the card, autograd on, or the plan's
    own reason (ctx.shade_refusal). Reads no tensor, so a chunk program can
    record the choice."""
    return _lane_refusal(device) or ctx.shade_refusal


def uniform_sample_one_light(ctx, params, hit: Hit, mat_ids, wo, frame, u, fam_lobes, mask):
    """One-light MIS NEE for a shaded batch (integrator/mod.rs:13-97).

    u: dict of this bounce's sampler values; fam_lobes: the bounce's
    build_family_lobes output. mask: lanes whose NEE result is consumed —
    the shadow/MIS rays of other lanes get t_max 0, so the traversal's box
    tests cull them at once (their radiance is discarded by the caller
    either way). Returns (N,3) radiance, already multiplied by the light
    count.

    Where nee_refusal finds nothing against them (lanes on the card,
    autograd off, area-triangle lights, lobe kinds the kernels implement)
    it runs the two CUDA kernels of csrc/nee.cu (ops/kernels/nee.py) around
    the same two walks, and counts `nee_kernel` on the open span; otherwise
    the plain path below, their plain version, counted `nee_plain`.
    """
    if nee_refusal(ctx, hit.p.device) is None:
        trace.count("nee_kernel", 1)
        return NK.nee(ctx, params, hit, mat_ids, wo, frame, u, fam_lobes, mask)
    trace.count("nee_plain", 1)
    return uniform_sample_one_light_plain(ctx, params, hit, mat_ids, wo, frame, u, fam_lobes,
                                          mask)


def uniform_sample_one_light_plain(ctx, params, hit: Hit, mat_ids, wo, frame, u, fam_lobes,
                                   mask):
    """uniform_sample_one_light in PyTorch ops: the plain version of the
    kernels, and the path of every call they do not take."""
    if ctx.n_lights == 0:
        return torch.zeros_like(wo)
    fx, fy, fz = frame
    p, n, perr = hit.p, hit.n, hit.p_error
    light_L = params["light_L"]

    # pick one light uniformly (get_usize — sampler/mod.rs:26-35)
    lf = u["light_pick"] * float(ctx.n_lights)
    light_idx = torch.clamp(lf.to(torch.int32), max=ctx.n_lights - 1).long()

    ls = LT.sample_li(
        ctx.lights, ctx.dev_lights, ctx.envs, light_L, light_idx, p, n, perr,
        torch.stack([u["light_u"], u["light_v"]], dim=-1),
    )
    chosen_delta = ctx.dev_lights.is_delta[light_idx]

    # --- light strategy
    wi_l = m.to_local(ls.wi, fx, fy, fz)
    wo_l = m.to_local(wo, fx, fy, fz)
    f, f_pdf, f_pres = shade_eval(ctx, fam_lobes, mat_ids, wo_l, wi_l)
    occluded = ctx.predicate(ls.vis_o, ls.vis_d, torch.where(mask, ls.vis_tmax, 0.0))
    cos_term = torch.abs(m.dot(n, ls.wi))
    safe_li_pdf = torch.where(ls.pdf == 0, 1.0, ls.pdf)
    weight = torch.where(chosen_delta, 1.0, m.power_heuristic(ls.pdf, f_pdf))

    # --- BSDF strategy (non-delta lights only, integrator/mod.rs:54-90)
    wi2_l, f2, f2_pdf, f2_pres = shade_sample_nondelta(
        ctx, fam_lobes, mat_ids, wo_l, u["nee_u"], u["nee_v"]
    )
    wi2 = m.to_world(wi2_l, fx, fy, fz)
    o2 = offset_point_by_error(p, n, perr, wi2)
    # slim intersect: the MIS leg needs only hit identity + distance; the
    # light's own table supplies its surface normal
    hit2_t, hit2_prim = ctx.intersect_tprim(o2, wi2, torch.where(mask, _FMAX, 0.0))

    ld_light = ls.li * f * (cos_term * weight / safe_li_pdf)[:, None]
    ok = ls.present & (ls.pdf != 0) & f_pres & (f_pdf != 0) & ~occluded
    ld_light = torch.where(ok[:, None], ld_light, 0.0)
    hit2_light = ctx.prim_light[torch.clamp(hit2_prim, min=0).long()]
    hit2_light = torch.where(hit2_prim >= 0, hit2_light, -1)
    same_light = (hit2_light >= 0) & (hit2_light == light_idx)
    hit2_p = o2 + torch.where(same_light, hit2_t, 0.0)[:, None] * wi2
    same_idx = torch.where(same_light, light_idx, -1)
    li2 = LT.le_emitted(light_L, same_idx)
    li2_pdf = LT.le_pdf(ctx.lights, ctx.dev_lights, same_idx, p, hit2_p)
    cos2 = torch.abs(m.dot(n, wi2))
    safe_f2_pdf = torch.where(f2_pdf == 0, 1.0, f2_pdf)
    ld_hit = li2 * f2 * (cos2 * m.power_heuristic(f2_pdf, li2_pdf) / safe_f2_pdf)[:, None]
    ok_hit = same_light & (li2_pdf != 0)

    ld_esc = 0.0  # escaped-env MIS leg through the CHOSEN light's own map
    if ctx.envs:
        chosen_inf = ctx.dev_lights.type_id[light_idx] == LT.TYPE_INFINITE
        eids = ctx.dev_lights.env_id[light_idx]
        le3, le3_pdf = torch.zeros_like(wi2), torch.zeros_like(cos2)
        for eid, env in enumerate(ctx.envs):
            sel_e = eids == eid
            le3 = torch.where(sel_e[:, None], LT.eval_env(env, wi2), le3)
            le3_pdf = torch.where(sel_e, LT.env_out_scene_pdf(env, wi2), le3_pdf)
        le3 = le3 * light_L[light_idx]
        ld_esc = le3 * f2 * (cos2 * m.power_heuristic(f2_pdf, le3_pdf) / safe_f2_pdf)[:, None]
        ok_esc = (hit2_prim < 0) & chosen_inf & (le3_pdf != 0)
        ld_esc = torch.where(ok_esc[:, None], ld_esc, 0.0)
    ld_bsdf = torch.where(ok_hit[:, None], ld_hit, ld_esc)
    ld_bsdf = torch.where(((~chosen_delta) & f2_pres & (f2_pdf != 0))[:, None], ld_bsdf, 0.0)
    return (ld_light + ld_bsdf) * float(ctx.n_lights)


def continue_path(ctx, hit: Hit, mat_ids, o, d, beta, specular, active, frame, u, fam_lobes,
                  bounce: int):
    """The path's continuation at one bounce (path.rs:41-56): the BSDF
    sample across families, the spawned ray, the throughput and the path
    state's update, then Russian roulette past bounce 3. `active`: the lanes
    alive at this hit; u: the bounce's sampler values; fam_lobes: the
    bounce's build_family_lobes output. Returns the new (o, d, beta,
    specular, active).

    Where continuation_refusal finds nothing against it (lanes on the card,
    autograd off, lobe kinds the kernel implements) it runs the CUDA kernel
    of csrc/shade.cu (ops/kernels/shade.py), and counts `shade_kernel` on
    the open span; otherwise the plain path below, its plain version,
    counted `shade_plain`.
    """
    if continuation_refusal(ctx, hit.p.device) is None:
        trace.count("shade_kernel", 1)
        return SK.continuation(ctx, hit, mat_ids, o, d, beta, specular, active, frame, u,
                               fam_lobes, bounce)
    trace.count("shade_plain", 1)
    return continue_path_plain(ctx, hit, mat_ids, o, d, beta, specular, active, frame, u,
                               fam_lobes, bounce)


def continue_path_plain(ctx, hit: Hit, mat_ids, o, d, beta, specular, active, frame, u,
                        fam_lobes, bounce: int):
    """continue_path in PyTorch ops: the plain version of the kernel, and
    the path of every call it does not take."""
    fx, fy, fz = frame
    wo_l = m.to_local(-d, fx, fy, fz)
    wi_l, f, pdf, pres, is_delta = shade_sample(
        ctx, fam_lobes, mat_ids, wo_l, u["bsdf_bucket"], u["bsdf_extra"]
    )
    wi = m.to_world(wi_l, fx, fy, fz)
    cont = active & pres & (pdf != 0)
    safe_pdf = torch.where(pdf == 0, 1.0, pdf)
    throughput = f * (torch.abs(m.dot(wi, hit.n)) / safe_pdf)[:, None]
    beta = torch.where(cont[:, None], beta * throughput, beta)
    o = torch.where(cont[:, None], offset_point_by_error(hit.p, hit.n, hit.p_error, wi), o)
    d = torch.where(cont[:, None], wi, d)
    specular = torch.where(cont, is_delta, specular)
    active = cont

    # Russian roulette after bounce 3 (path.rs:47-56)
    if bounce > 3:
        q = torch.clamp(1.0 - B.luminance(beta), min=0.05)
        active = active & ~(u["rr"] < q)
        beta = beta / torch.clamp(1.0 - q, min=1e-6)[:, None]
    return o, d, beta, specular, active


def _bounce_u(indices, dim_base: int, bounce: int, cfg: HaltonConfig, perms):
    """This bounce's 8 sampler values. The RR dim is consumed only past
    bounce 3; earlier it is a zero plane, as in the JAX package."""
    dim0 = dim_base + DIMS_PER_BOUNCE * bounce
    return {
        key: (torch.zeros(indices.shape, dtype=torch.float32, device=indices.device)
              if (k == D_RR and bounce <= 3)
              else halton_sample(indices, dim0 + k, cfg, perms))
        for k, key in enumerate(_U_KEYS)
    }


def path_trace(
    ctx: ShadeContext,
    params,
    o, d,  # (N,3) camera rays
    indices,  # (N,) int64 halton indices
    cfg: HaltonConfig,
    perms,
    max_depth: int,
    dim_base: int,
    count_rays: bool = False,
):
    """PathIntegrator::li over a ray batch → (N,3) radiance.

    With count_rays=True returns (radiance, segments): segments is a 0-d
    int64 tensor counting traced ray segments (closest + shadow + MIS over
    working lanes), the bench unit. The JAX package sums it in float32;
    the count here is exact.
    """
    N = o.shape[0]
    light_L = params["light_L"]

    def emission(L, beta, gate, hit_prim, hit_valid, d):
        hit_light = ctx.prim_light[torch.clamp(hit_prim, min=0).long()]
        hit_light = torch.where(hit_prim >= 0, hit_light, -1)
        L = L + beta * LT.le_emitted(light_L, torch.where(gate, hit_light, -1))
        if ctx.envs:  # escaped rays see the environment
            esc = LT.le_out_scene_total(ctx.dev_lights, ctx.envs, light_L, d)
            L = L + torch.where((gate & ~hit_valid)[:, None], beta * esc, 0.0)
        return L

    L = torch.zeros((N, 3), dtype=torch.float32, device=o.device)
    beta = torch.ones((N, 3), dtype=torch.float32, device=o.device)
    active = torch.ones((N,), dtype=torch.bool, device=o.device)
    specular = torch.zeros((N,), dtype=torch.bool, device=o.device)
    segments = torch.zeros((), dtype=torch.int64, device=o.device)

    for bounce in range(max_depth):
        trace.stage("sample")
        u = _bounce_u(indices, dim_base, bounce, cfg, perms)
        trace.stage("intersect")
        # dead lanes carry a stale ray; t_max 0 makes every box test in the
        # traversal fail at once for them
        hit = ctx.intersect(o, d, torch.where(active, _FMAX, 0.0))
        segments = segments + active.sum()

        gate = active if bounce == 0 else active & specular
        L = emission(L, beta, gate, hit.prim, hit.valid, d)

        mat_ids = ctx.prim_mat[torch.clamp(hit.prim, min=0).long()]
        mat_ids = torch.where(hit.prim >= 0, mat_ids, -1)
        active = active & hit.valid & (mat_ids >= 0)  # (path.rs:30-34,64)

        trace.stage("shade")
        # the frame only where a plain path (NEE's or the continuation's)
        # reads it: the kernels build their own
        plain = (nee_refusal(ctx, o.device) is not None
                 or continuation_refusal(ctx, o.device) is not None)
        frame = _shading_frame(hit.n) if plain else None
        wo = -d
        is_all_delta = ctx.mat_is_all_delta[torch.clamp(mat_ids, min=0).long()]

        # one lobe build serves NEE (eval + sample) and the continuation
        fam_lobes = build_family_lobes(ctx, mat_ids, hit.uv, params)
        shaded = active & ~is_all_delta
        trace.stage("nee")
        nee = uniform_sample_one_light(ctx, params, hit, mat_ids, wo, frame, u, fam_lobes,
                                       mask=shaded)
        L = L + torch.where(shaded[:, None], beta * nee, 0.0)
        segments = segments + 2 * shaded.sum()

        trace.stage("shade")
        o, d, beta, specular, active = continue_path(ctx, hit, mat_ids, o, d, beta, specular,
                                                     active, frame, u, fam_lobes, bounce)

    # final iteration (bounce == max_depth): emission only, then stop —
    # slim (t, prim) traversal; no attributes needed past the last shade
    trace.stage("intersect")
    _t_f, prim_f = ctx.intersect_tprim(o, d, torch.where(active, _FMAX, 0.0))
    segments = segments + active.sum()
    gate = active if max_depth == 0 else active & specular
    L = emission(L, beta, gate, prim_f, prim_f >= 0, d)

    if count_rays:
        return L, segments
    return L


def direct_light_trace(
    ctx: ShadeContext,
    params,
    o, d,  # (N,3) camera rays
    indices,  # (N,) int64 halton indices
    cfg: HaltonConfig,
    perms,
    max_depth: int,
    dim_base: int,
    max_delta_lobes: int,
    count_rays: bool = False,
):
    """DirectLightIntegrator::li — NEE at the hit plus recursion through the
    delta lobes (direct_light.rs:12-42).

    The reference enumerates every delta branch per ray; here each lane
    follows ONE delta lobe, chosen luminance-weighted through
    bsdf_sample_delta and reweighted by 1/p (an unbiased estimator of the
    same sum in one batch trace per level). The choice consumes the level's
    D_BSDF_BUCKET sampler dim, so renders stay deterministic. Level `depth`
    reads sampler dims dim_base + 8·depth + k, as the JAX package does.

    With count_rays=True returns (radiance, segments): the closest hit per
    live lane plus the NEE shadow / MIS pair per shaded lane, path_trace's
    accounting, as an exact 0-d int64 count.
    """
    light_L = params["light_L"]

    def level(o, d, weight, live, depth):
        N = o.shape[0]
        trace.stage("intersect")
        hit = ctx.intersect(o, d, torch.where(live, _FMAX, 0.0))
        segments = live.sum()
        prim = torch.clamp(hit.prim, min=0).long()
        hit_light = torch.where(hit.prim >= 0, ctx.prim_light[prim], -1)
        mat_ids = torch.where(hit.prim >= 0, ctx.prim_mat[prim], -1)
        has_mat = hit.valid & (mat_ids >= 0) & live

        # emission of a hit light (direct_light.rs:33-35), escaped env else
        out = weight * LT.le_emitted(light_L, torch.where(live & (hit_light >= 0), hit_light, -1))
        if ctx.envs:
            esc = LT.le_out_scene_total(ctx.dev_lights, ctx.envs, light_L, d)
            out = out + torch.where((live & ~hit.valid)[:, None], weight * esc, 0.0)

        trace.stage("sample")
        dim0 = dim_base + DIMS_PER_BOUNCE * depth
        u = {key: halton_sample(indices, dim0 + k, cfg, perms)
             for k, key in enumerate(_U_KEYS[:D_BSDF_BUCKET])}
        trace.stage("shade")
        frame = _shading_frame(hit.n)
        wo = -m.normalize(d)
        fam_lobes = build_family_lobes(ctx, mat_ids, hit.uv, params)
        trace.stage("nee")
        nee = uniform_sample_one_light(ctx, params, hit, mat_ids, wo, frame, u, fam_lobes,
                                       mask=has_mat)
        out = out + torch.where(has_mat[:, None], weight * nee, 0.0)
        segments = segments + 2 * has_mat.sum()

        if depth + 1 < max_depth and max_delta_lobes > 0:
            trace.stage("sample")
            u_bucket = halton_sample(indices, dim0 + D_BSDF_BUCKET, cfg, perms)
            trace.stage("shade")
            fx, fy, fz = frame
            wo_l = m.to_local(wo, fx, fy, fz)
            bwi, bf = _zeros(N, 3, like=o), _zeros(N, 3, like=o)
            bpdf, bok = _zeros(N, like=o), _zeros(N, dtype=torch.bool, like=o)
            for fam, all_lobes in fam_lobes:
                lobes = [lobe for lobe in all_lobes if lobe.is_delta]
                if not lobes:
                    continue
                wi_l, f_l, p_l, ok_l = B.bsdf_sample_delta(lobes, wo_l, u_bucket)
                sel = fam.mask(mat_ids)
                bwi = torch.where(sel[:, None], m.to_world(wi_l, fx, fy, fz), bwi)
                bf = torch.where(sel[:, None], f_l, bf)
                bpdf = torch.where(sel, p_l, bpdf)
                bok = torch.where(sel, ok_l, bok)
            blive = has_mat & bok & (bpdf > 0)
            cosw = torch.abs(m.dot(hit.n, bwi))
            bo = offset_point_by_error(hit.p, hit.n, hit.p_error, bwi)
            safe_pdf = torch.where(bpdf > 0, bpdf, 1.0)
            wnext = torch.where(blive[:, None], weight * bf * (cosw / safe_pdf)[:, None], 0.0)
            sub_out, sub_seg = level(bo, bwi, wnext, blive, depth + 1)
            out = out + sub_out
            segments = segments + sub_seg
        return out, segments

    N = o.shape[0]
    out, segments = level(o, d, torch.ones((N, 3), dtype=torch.float32, device=o.device),
                          torch.ones((N,), dtype=torch.bool, device=o.device), 0)
    if count_rays:
        return out, segments
    return out


def mat_all_delta_table(materials, registry) -> np.ndarray:
    """(M_total,) host bool: materials whose lobes are all delta lobes."""
    n_mats = max((mat.mat_id for mat in materials), default=-1) + 1
    all_delta = np.zeros((max(n_mats, 1),), bool)
    for mat in materials:
        try:
            kinds = lobe_kinds(mat, registry)
        except KeyError:
            kinds = []
        all_delta[mat.mat_id] = bool(kinds) and all(k in B.DELTA_KINDS for k in kinds)
    return all_delta

