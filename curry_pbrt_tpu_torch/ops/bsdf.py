"""Batched BSDF lobes and per-material-instance BSDF algebra (counterpart of
the JAX package's ops/bsdf.py).

A material instance compiles to a STATIC list of lobes, each carrying
batched per-ray parameters; all lobe math runs in the shading-local frame
(normal = +z) on (N, ...) tensors, with `torch.where` masks in place of the
reference's Option returns.

Ported lobes: lambert_r, spec_r (dielectric or no-op Fresnel) and spec_t —
what matte, glass and mirror need. oren_nayar, lambert_t and the GGX lobes
raise NotImplementedError until ROADMAP Queue 1 item 5 ports them.

Reference algorithm mapping:
  bsdf_eval_pdf        ← BSDF::no_delta_f_pdf      (bxdf/mod.rs:176-198)
  bsdf_sample_nondelta ← BSDF::sample_no_delta_f   (bxdf/mod.rs:148-159)
  bsdf_sample_delta    ← BSDF::sample_delta_f      (bxdf/mod.rs:160-175)
  bsdf_sample          ← BSDF::sample_f            (bxdf/mod.rs:199-214)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from curry_pbrt_tpu_torch.dtypes import INV_PI
from curry_pbrt_tpu_torch.ops import math as m

NONDELTA_KINDS = ("lambert_r", "lambert_t", "oren_nayar", "ggx_r", "ggx_t")
DELTA_KINDS = ("spec_r", "spec_t")
REFLECT_KINDS = ("lambert_r", "oren_nayar", "ggx_r")
PORTED_KINDS = ("lambert_r", "spec_r", "spec_t")


@dataclass
class Lobe:
    """One lobe with batched parameters. `kind` is static; tensors are (N, …)."""

    kind: str
    albedo: torch.Tensor  # (N,3) — texture-evaluated
    on_a: Optional[torch.Tensor] = None  # oren-nayar A/B
    on_b: Optional[torch.Tensor] = None
    alpha_x: Optional[torch.Tensor] = None  # GGX
    alpha_y: Optional[torch.Tensor] = None
    eta_a: Optional[torch.Tensor] = None  # dielectric interface (spec_*, ggx_*)
    eta_b: Optional[torch.Tensor] = None
    fresnel_noop: bool = False  # mirror (specular.rs:17-23)

    @property
    def is_delta(self) -> bool:
        return self.kind in DELTA_KINDS

    @property
    def is_reflect(self) -> bool:
        return self.kind in REFLECT_KINDS


def _not_ported(kind: str):
    return NotImplementedError(
        f"BSDF lobe {kind!r} is not ported to curry_pbrt_tpu_torch yet "
        "(ROADMAP.md Queue 1 item 5); ported lobes: " + ", ".join(PORTED_KINDS)
    )


def luminance(rgb):
    return 0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1] + 0.072169 * rgb[..., 2]


# ---------------------------------------------------------------------------
# Fresnel — specular.rs:24-44


def fresnel_dielectric(cos_i, eta_i, eta_t):
    """Unpolarized dielectric Fresnel reflectance; handles both sides and TIR."""
    ei = torch.where(cos_i > 0, eta_i, eta_t)
    et = torch.where(cos_i > 0, eta_t, eta_i)
    ci = torch.abs(cos_i)
    si = m.safe_sqrt(1.0 - ci * ci)
    st = si * ei / et
    tir = st >= 1.0
    ct = m.safe_sqrt(1.0 - st * st)
    r_par = (et * ci - ei * ct) / (et * ci + ei * ct)
    r_perp = (ei * ci - et * ct) / (ei * ci + et * ct)
    fr = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(tir, 1.0, fr)


def roughness_to_alpha(rough):
    """pbrt's log-polynomial remap (microfacet.rs:28-33); material lobe
    plans use it even though the GGX lobes themselves are not ported."""
    rough = torch.clamp(rough, min=1e-3)
    x = torch.log(rough)
    x2 = x * x
    return 1.62142 + 0.819955 * x + 0.1734 * x2 + 0.0171201 * x * x2 + 0.000640711 * x2 * x2


# ---------------------------------------------------------------------------
# non-delta lobe eval / pdf / sample


def lobe_f(lobe: Lobe, wo, wi):
    """(f: (N,3), present: (N,)). Masked analog of `BxDF::f` returning None."""
    if lobe.kind == "lambert_r":
        return lobe.albedo * float(INV_PI), torch.ones(wo.shape[:-1], dtype=torch.bool, device=wo.device)
    raise _not_ported(lobe.kind)


def lobe_pdf(lobe: Lobe, wo, wi):
    """Reference default pdf = |cosθ|/π for every non-delta lobe."""
    return torch.abs(m.cos_theta(wi)) * float(INV_PI)


def lobe_sample(lobe: Lobe, wo, u):
    """Sample wi from one lobe: (wi, f, pdf, present). Cosine hemisphere
    flipped to wo's side (bxdf/mod.rs:20-37)."""
    if lobe.kind != "lambert_r":
        raise _not_ported(lobe.kind)
    wi, pdf = m.cosine_sample_hemisphere(u)
    z = wi[..., 2:3]  # ≥ 0 from the sampler
    zt = torch.where(wo[..., 2:3] < 0, -z, z)
    wi = torch.cat([wi[..., :2], zt], dim=-1)
    f, present = lobe_f(lobe, wo, wi)
    return wi, f, pdf, present


# ---------------------------------------------------------------------------
# delta lobes — specular.rs


def delta_lobe_sample(lobe: Lobe, wo):
    """(wi, f, present) for a delta lobe."""
    k = lobe.kind
    if k == "spec_r":
        wi = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)
        ci = m.cos_theta(wi)
        fr = (
            torch.ones_like(ci)
            if lobe.fresnel_noop
            else fresnel_dielectric(ci, lobe.eta_a, lobe.eta_b)
        )
        f = lobe.albedo * (fr / torch.clamp(torch.abs(ci), min=1e-12))[..., None]
        return wi, f, fr != 0.0
    if k == "spec_t":
        pos = m.cos_theta(wo) > 0
        eta = torch.where(pos, lobe.eta_a / lobe.eta_b, lobe.eta_b / lobe.eta_a)
        n = torch.cat([torch.zeros_like(wo[..., :2]), torch.sign(wo[..., 2:3])], dim=-1)
        wi, ok = m.refract(wo, n, eta)
        ft = 1.0 - fresnel_dielectric(m.cos_theta(wi), lobe.eta_a, lobe.eta_b)
        f = lobe.albedo * (ft / torch.clamp(torch.abs(m.cos_theta(wi)), min=1e-12))[..., None]
        return wi, f, ok & (ft != 0.0)
    raise ValueError(k)


# ---------------------------------------------------------------------------
# BSDF-level algebra over a static lobe list


def _zeros(wo, *tail, dtype=torch.float32):
    return torch.zeros(wo.shape[:-1] + tail, dtype=dtype, device=wo.device)


def bsdf_eval_pdf(lobes: List[Lobe], wo, wi):
    """no_delta_f_pdf: sum f and mean cosine pdf over the hemisphere bucket
    selected by sign(wo.z · wi.z) (bxdf/mod.rs:176-198).

    Returns (f: (N,3), pdf: (N,), present: (N,)).
    """
    nd = [l for l in lobes if not l.is_delta]
    if not nd:
        return _zeros(wo, 3), _zeros(wo), _zeros(wo, dtype=torch.bool)
    reflect = wo[..., 2] * wi[..., 2] > 0
    n_refl = sum(1 for l in nd if l.is_reflect)
    n_trans = len(nd) - n_refl
    f_r, pdf_r, pres_r = _zeros(wo, 3), _zeros(wo), _zeros(wo, dtype=torch.bool)
    f_t, pdf_t, pres_t = _zeros(wo, 3), _zeros(wo), _zeros(wo, dtype=torch.bool)
    for l in nd:
        lf, lp = lobe_f(l, wo, wi)
        lpdf = lobe_pdf(l, wo, wi)
        # the reference's if-let only accumulates (f, pdf) when f is Some
        if l.is_reflect:
            f_r = f_r + torch.where(lp[..., None], lf, 0.0)
            pdf_r = pdf_r + torch.where(lp, lpdf, 0.0)
            pres_r = pres_r | lp
        else:
            f_t = f_t + torch.where(lp[..., None], lf, 0.0)
            pdf_t = pdf_t + torch.where(lp, lpdf, 0.0)
            pres_t = pres_t | lp
    if n_refl:
        pdf_r = pdf_r / float(n_refl)
    if n_trans:
        pdf_t = pdf_t / float(n_trans)
    if n_refl and n_trans:
        f = torch.where(reflect[..., None], f_r, f_t)
        pdf = torch.where(reflect, pdf_r, pdf_t)
        present = torch.where(reflect, pres_r, pres_t)
    elif n_refl:
        f = torch.where(reflect[..., None], f_r, 0.0)
        pdf = torch.where(reflect, pdf_r, 0.0)
        present = reflect & pres_r
    else:
        f = torch.where(~reflect[..., None], f_t, 0.0)
        pdf = torch.where(~reflect, pdf_t, 0.0)
        present = (~reflect) & pres_t
    return f, pdf, present


def bsdf_sample_nondelta(lobes: List[Lobe], wo, u_pick, u2):
    """sample_no_delta_f: uniform lobe choice over ALL non-delta lobes, pdf
    divided by the count (bxdf/mod.rs:136-159). → (wi, f, pdf, present)."""
    nd = [l for l in lobes if not l.is_delta]
    if not nd:
        return _zeros(wo, 3), _zeros(wo, 3), _zeros(wo), _zeros(wo, dtype=torch.bool)
    nb = len(nd)
    idx, remap = m.sample_usize_remap(u_pick, nb)
    u = torch.stack([remap, u2], dim=-1)
    wi_o, f_o, pdf_o = _zeros(wo, 3), _zeros(wo, 3), _zeros(wo)
    pres_o = _zeros(wo, dtype=torch.bool)
    for i, l in enumerate(nd):
        wi, f, pdf, pres = lobe_sample(l, wo, u)
        sel = idx == i
        wi_o = torch.where(sel[..., None], wi, wi_o)
        f_o = torch.where(sel[..., None], f, f_o)
        pdf_o = torch.where(sel, pdf, pdf_o)
        pres_o = torch.where(sel, pres, pres_o)
    return wi_o, f_o, pdf_o / float(nb), pres_o


def bsdf_sample_delta(lobes: List[Lobe], wo, u):
    """sample_delta_f: luminance-weighted choice among the delta lobes that
    produced a sample (bxdf/mod.rs:160-175). → (wi, f, pdf, present)."""
    dl = [l for l in lobes if l.is_delta]
    if not dl:
        return _zeros(wo, 3), _zeros(wo, 3), _zeros(wo), _zeros(wo, dtype=torch.bool)
    samples = [delta_lobe_sample(l, wo) for l in dl]
    weights = [torch.where(ok, torch.clamp(luminance(f), min=0.0), 0.0) for (_, f, ok) in samples]
    total = weights[0]
    for w in weights[1:]:
        total = total + w
    any_ok = total > 0
    safe_total = torch.where(any_ok, total, 1.0)
    # CDF walk over the per-lane weight list
    target = u * safe_total
    cum = _zeros(wo)
    chosen = torch.full(wo.shape[:-1], len(dl) - 1, dtype=torch.int32, device=wo.device)
    done = _zeros(wo, dtype=torch.bool)
    for i, w in enumerate(weights):
        cum = cum + w
        take = (~done) & (target <= cum) & (w > 0)
        chosen = torch.where(take, i, chosen)
        done = done | take
    wi_o, f_o, pdf_o = _zeros(wo, 3), _zeros(wo, 3), _zeros(wo)
    pres_o = _zeros(wo, dtype=torch.bool)
    for i, ((wi, f, ok), w) in enumerate(zip(samples, weights)):
        sel = (chosen == i) & ok
        wi_o = torch.where(sel[..., None], wi, wi_o)
        f_o = torch.where(sel[..., None], f, f_o)
        pdf_o = torch.where(sel, w / safe_total, pdf_o)
        pres_o = pres_o | sel
    return wi_o, f_o, pdf_o, pres_o & any_ok


def bsdf_sample(lobes: List[Lobe], wo, u_bucket, u_extra):
    """sample_f: pick delta vs non-delta bucket with probability proportional
    to lobe counts, then sample within (bxdf/mod.rs:199-214).

    Returns (wi, f, pdf, present, is_delta_mask).
    """
    nb = sum(1 for l in lobes if not l.is_delta)
    ndl = sum(1 for l in lobes if l.is_delta)
    if nb == 0 and ndl == 0:
        z = _zeros(wo, dtype=torch.bool)
        return _zeros(wo, 3), _zeros(wo, 3), _zeros(wo), z, z
    # bucket probabilities rounded in f32, as the JAX package computes them
    p_nb32 = np.float32(nb) / np.float32(nb + ndl)
    p_nb, p_d = float(p_nb32), float(np.float32(1.0) - p_nb32)
    if ndl == 0:
        # counts [nb, 0] → cdf [1, 1]: bucket pdf 1, remap = 1 - u
        wi, f, pdf, pres = bsdf_sample_nondelta(lobes, wo, 1.0 - u_bucket, u_extra)
        return wi, f, pdf, pres, _zeros(wo, dtype=torch.bool)
    if nb == 0:
        # counts [0, nd] → cdf [0, 1]: bucket pdf 1, remap = 1 - u
        wi, f, pdf, pres = bsdf_sample_delta(lobes, wo, 1.0 - u_bucket)
        return wi, f, pdf, pres, torch.ones(wo.shape[:-1], dtype=torch.bool, device=wo.device)
    # both buckets present: cdf = [p_nb, 1]; remap = (cdf_i - u)/pdf_i
    pick_nd = u_bucket <= p_nb
    remap_nd = (p_nb - u_bucket) / p_nb
    remap_d = (1.0 - u_bucket) / p_d
    wi_n, f_n, pdf_n, pres_n = bsdf_sample_nondelta(lobes, wo, remap_nd, u_extra)
    wi_d, f_d, pdf_d, pres_d = bsdf_sample_delta(lobes, wo, remap_d)
    wi = torch.where(pick_nd[..., None], wi_n, wi_d)
    f = torch.where(pick_nd[..., None], f_n, f_d)
    pdf = torch.where(pick_nd, pdf_n * p_nb, pdf_d * p_d)
    pres = torch.where(pick_nd, pres_n, pres_d)
    return wi, f, pdf, pres, ~pick_nd
