"""Wavefront MIS-NEE path tracing (counterpart of the JAX package's
models/integrators.py, path integrator).

The whole ray batch lives in SoA tensors; a fixed-depth bounce loop runs
over fixed-shape tensors with active-lane masks:

    for bounce in 0..max_depth:
        closest hit → emission (bounce 0 / specular chains)
        → NEE (pick light, shadow ray, MIS; + BSDF-strategy leg)
        → BSDF sample → spawn continuation → Russian roulette (mask+reweight)
    final bounce: (t, prim) hit → emission

The JAX package runs the bounces as a `lax.scan`; here it is a Python loop
whose body never reads a value back to the host, so the host only enqueues
work. Every lane consumes the same statically assigned Halton dimensions per
bounce (8: light pick, light 2D, NEE-BSDF 2D, BSDF bucket + extra, RR), so
images match the JAX package sample for sample.

Algorithm mapping to the reference:
  uniform_sample_one_light ← integrator/mod.rs:13-97
  path_trace               ← integrator/path.rs:13-66 (emission gating on
      bounce-0/specular, NEE gating on is_all_delta, RR after bounce 3 with
      q = max(0.05, 1−β.y), throughput update β·f·|cosθ|/pdf)
The direct-lighting integrator waits for ROADMAP.md Queue 1 item 9.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List

import numpy as np
import torch

from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX
from curry_pbrt_tpu_torch.models import lights as LT
from curry_pbrt_tpu_torch.models.materials import CompiledMaterial, MaterialFamily, lobe_kinds
from curry_pbrt_tpu_torch.ops import bsdf as B
from curry_pbrt_tpu_torch.ops import math as m
from curry_pbrt_tpu_torch.ops.halton import HaltonConfig, halton_sample
from curry_pbrt_tpu_torch.ops.intersect import Hit, offset_point_by_error

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
    envs: List[LT.EnvMap]  # one per infinite light (lights.env_id indexes)
    n_lights: int
    mat_is_all_delta: torch.Tensor  # (M_total,) bool, indexed by mat_id
    intersect: Callable  # (o, d, t_max) -> Hit
    predicate: Callable  # (o, d, t_max) -> (N,) bool
    intersect_tprim: Callable  # (o, d, t_max) -> (t, prim) — slim MIS-leg path
    prim_mat: torch.Tensor  # (P,) i32
    prim_light: torch.Tensor  # (P,) i32


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


def uniform_sample_one_light(ctx, params, hit: Hit, mat_ids, wo, frame, u, fam_lobes, mask):
    """One-light MIS NEE for a shaded batch (integrator/mod.rs:13-97).

    u: dict of this bounce's sampler values; fam_lobes: the bounce's
    build_family_lobes output. mask: lanes whose NEE result is consumed —
    the shadow/MIS rays of other lanes get t_max 0, so the traversal's box
    tests cull them at once (their radiance is discarded by the caller
    either way). Returns (N,3) radiance, already multiplied by the light
    count.
    """
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

    ld_bsdf = torch.where(ok_hit[:, None], ld_hit, 0.0)
    ld_bsdf = torch.where(((~chosen_delta) & f2_pres & (f2_pdf != 0))[:, None], ld_bsdf, 0.0)
    return (ld_light + ld_bsdf) * float(ctx.n_lights)


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
            esc = LT.le_out_scene_total(ctx.lights, ctx.envs, light_L, d)
            L = L + torch.where((gate & ~hit_valid)[:, None], beta * esc, 0.0)
        return L

    L = torch.zeros((N, 3), dtype=torch.float32, device=o.device)
    beta = torch.ones((N, 3), dtype=torch.float32, device=o.device)
    active = torch.ones((N,), dtype=torch.bool, device=o.device)
    specular = torch.zeros((N,), dtype=torch.bool, device=o.device)
    segments = torch.zeros((), dtype=torch.int64, device=o.device)

    for bounce in range(max_depth):
        u = _bounce_u(indices, dim_base, bounce, cfg, perms)
        # dead lanes carry a stale ray; t_max 0 makes every box test in the
        # traversal fail at once for them
        hit = ctx.intersect(o, d, torch.where(active, _FMAX, 0.0))
        segments = segments + active.sum()

        gate = active if bounce == 0 else active & specular
        L = emission(L, beta, gate, hit.prim, hit.valid, d)

        mat_ids = ctx.prim_mat[torch.clamp(hit.prim, min=0).long()]
        mat_ids = torch.where(hit.prim >= 0, mat_ids, -1)
        active = active & hit.valid & (mat_ids >= 0)  # (path.rs:30-34,64)

        frame = _shading_frame(hit.n)
        wo = -d
        is_all_delta = ctx.mat_is_all_delta[torch.clamp(mat_ids, min=0).long()]

        # one lobe build serves NEE (eval + sample) and the continuation
        fam_lobes = build_family_lobes(ctx, mat_ids, hit.uv, params)
        shaded = active & ~is_all_delta
        nee = uniform_sample_one_light(ctx, params, hit, mat_ids, wo, frame, u, fam_lobes,
                                       mask=shaded)
        L = L + torch.where(shaded[:, None], beta * nee, 0.0)
        segments = segments + 2 * shaded.sum()

        # continuation (path.rs:41-46)
        fx, fy, fz = frame
        wo_l = m.to_local(wo, fx, fy, fz)
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

    # final iteration (bounce == max_depth): emission only, then stop —
    # slim (t, prim) traversal; no attributes needed past the last shade
    _t_f, prim_f = ctx.intersect_tprim(o, d, torch.where(active, _FMAX, 0.0))
    segments = segments + active.sum()
    gate = active if max_depth == 0 else active & specular
    L = emission(L, beta, gate, prim_f, prim_f >= 0, d)

    if count_rays:
        return L, segments
    return L


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

