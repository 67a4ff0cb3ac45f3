"""Batched BSDF lobes and per-material-instance BSDF algebra (counterpart of
the JAX package's ops/bsdf.py).

A material instance compiles to a STATIC list of lobes, each carrying
batched per-ray parameters; all lobe math runs in the shading-local frame
(normal = +z) on (N, ...) tensors, with `torch.where` masks in place of the
reference's Option returns.

Lobe kinds (suffix _r = reflect bucket, _t = transmit bucket):
  non-delta: lambert_r, lambert_t, oren_nayar, ggx_r, ggx_t
  delta:     spec_r, spec_t

Reference algorithm mapping:
  bsdf_eval_pdf        ← BSDF::no_delta_f_pdf      (bxdf/mod.rs:176-198)
  bsdf_sample_nondelta ← BSDF::sample_no_delta_f   (bxdf/mod.rs:148-159)
  bsdf_sample_delta    ← BSDF::sample_delta_f      (bxdf/mod.rs:160-175)
  bsdf_sample          ← BSDF::sample_f            (bxdf/mod.rs:199-214)
  delta lobes          ← DeltaBxDF impls           (bxdf/specular.rs)
  GGX                  ← TrowbridgeReitz           (bxdf/microfacet.rs)

The reference's default lobe pdf is wi.z/π even when wi is in the
transmission hemisphere (bxdf/mod.rs:38-40, can be negative); like the JAX
package, this uses |wi.z|/π.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from portbench.ref.dtypes import INV_PI, PI
from portbench.ref.ops import math as m

NONDELTA_KINDS = ("lambert_r", "lambert_t", "oren_nayar", "ggx_r", "ggx_t")
DELTA_KINDS = ("spec_r", "spec_t")
REFLECT_KINDS = ("lambert_r", "oren_nayar", "ggx_r")


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


def luminance(rgb):
    return 0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1] + 0.072169 * rgb[..., 2]


# ---------------------------------------------------------------------------
# Fresnel — specular.rs:24-44


def _ratio(num, den):
    """num / den for Fresnel's ratios, whose den = 0 only where num = 0
    too: NaN there, as the plain division gives it, but with a finite
    gradient. Lanes at cos θ = 0 (the masked lanes of other materials)
    would otherwise send 0 · NaN = NaN into the gradient of the
    interface's eta (the JAX package's gradient is NaN there)."""
    zero = den == 0
    return torch.where(zero, float("nan"), num / torch.where(zero, 1.0, den))


def fresnel_dielectric(cos_i, eta_i, eta_t):
    """Unpolarized dielectric Fresnel reflectance; handles both sides and TIR."""
    ei = torch.where(cos_i > 0, eta_i, eta_t)
    et = torch.where(cos_i > 0, eta_t, eta_i)
    ci = torch.abs(cos_i)
    si = m.safe_sqrt(1.0 - ci * ci)
    st = si * ei / et
    tir = st >= 1.0
    ct = m.safe_sqrt(1.0 - st * st)
    r_par = _ratio(et * ci - ei * ct, et * ci + ei * ct)
    r_perp = _ratio(ei * ci - et * ct, ei * ci + et * ct)
    fr = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(tir, 1.0, fr)


# ---------------------------------------------------------------------------
# Trowbridge-Reitz / GGX — microfacet.rs


def roughness_to_alpha(rough):
    """pbrt's log-polynomial remap (microfacet.rs:28-33)."""
    rough = torch.clamp(rough, min=1e-3)
    x = torch.log(rough)
    x2 = x * x
    return 1.62142 + 0.819955 * x + 0.1734 * x2 + 0.0171201 * x * x2 + 0.000640711 * x2 * x2


def tr_d(wh, alpha_x, alpha_y):
    t2 = m.tan2_theta(wh)
    bad = torch.isnan(t2) | torch.isinf(t2)
    t2 = torch.where(bad, 0.0, t2)
    c2 = m.cos2_theta(wh)
    c4 = c2 * c2
    e = (m.cos2_phi(wh) / (alpha_x * alpha_x) + m.sin2_phi(wh) / (alpha_y * alpha_y)) * t2
    d = 1.0 / (float(PI) * alpha_x * alpha_y * torch.clamp(c4, min=1e-20) * (1.0 + e) * (1.0 + e))
    return torch.where(bad, 0.0, d)


def tr_lambda(w, alpha_x, alpha_y):
    abs_tan = torch.abs(m.tan_theta(w))
    bad = torch.isnan(abs_tan) | torch.isinf(abs_tan)
    abs_tan = torch.where(bad, 0.0, abs_tan)
    alpha = torch.sqrt(m.cos2_phi(w) * alpha_x * alpha_x + m.sin2_phi(w) * alpha_y * alpha_y)
    at = alpha * abs_tan
    lam = (-1.0 + torch.sqrt(1.0 + at * at)) / 2.0
    return torch.where(bad, 0.0, lam)


def tr_g(wo, wi, ax, ay):
    return 1.0 / (1.0 + tr_lambda(wo, ax, ay) + tr_lambda(wi, ax, ay))


def tr_g1(w, ax, ay):
    return 1.0 / (1.0 + tr_lambda(w, ax, ay))


def tr_sample_wh(wo, u, ax, ay):
    """Visible-normal sampling (Heitz), exactly the reference's branchy
    version vectorized with masks (microfacet.rs:39-92).

    Returns (wh: (N,3), pdf: (N,)).
    """
    flip = wo[..., 2] < 0.0
    wi = torch.where(flip[..., None], -wo, wo)
    wi_str = m.normalize(torch.stack([ax * wi[..., 0], ay * wi[..., 1], wi[..., 2]], dim=-1))
    cti = m.cos_theta(wi_str)

    ux, uy = u[..., 0], u[..., 1]

    # near-normal incidence branch (cti > 0.9999)
    r_n = torch.sqrt(ux / torch.clamp(1.0 - ux, min=1e-12))
    phi_n = float(2.0 * PI) * uy
    sx_n = r_n * torch.cos(phi_n)
    sy_n = r_n * torch.sin(phi_n)

    # general branch
    st = m.safe_sqrt(1.0 - cti * cti)
    tan_t = st / torch.where(cti == 0, 1.0, cti)
    a = 1.0 / torch.where(tan_t == 0, 1.0, tan_t)
    g1 = 2.0 / (1.0 + torch.sqrt(1.0 + 1.0 / torch.clamp(a * a, min=1e-20)))
    A = 2.0 * ux / torch.clamp(g1, min=1e-12) - 1.0
    tmp = 1.0 / torch.where(A * A - 1.0 == 0, 1e-10, A * A - 1.0)
    tmp = torch.clamp(tmp, max=1e10)
    B = tan_t
    D = m.safe_sqrt(B * B * tmp * tmp - (A * A - B * B) * tmp)
    sx1 = B * tmp - D
    sx2 = B * tmp + D
    sx_g = torch.where((A < 0) | (sx2 > 1.0 / torch.where(tan_t == 0, 1e-12, tan_t)), sx1, sx2)
    S = torch.where(uy > 0.5, 1.0, -1.0)
    u2b = torch.where(uy > 0.5, 2.0 * (uy - 0.5), 2.0 * (0.5 - uy))
    z = (u2b * (u2b * (u2b * 0.27385 - 0.73369) + 0.46341)) / (
        u2b * (u2b * (u2b * 0.093073 + 0.309420) - 1.0) + 0.597999
    )
    sy_g = S * z * torch.sqrt(1.0 + sx_g * sx_g)

    near = cti > 0.9999
    slope_x = torch.where(near, sx_n, sx_g)
    slope_y = torch.where(near, sy_n, sy_g)

    cp, sp = m.cos_phi(wi_str), m.sin_phi(wi_str)
    rx = cp * slope_x - sp * slope_y
    ry = sp * slope_x + cp * slope_y
    slope_x = rx * ax
    slope_y = ry * ay
    wh = m.normalize(torch.stack([-slope_x, -slope_y, torch.ones_like(slope_x)], dim=-1))
    wh = torch.where(flip[..., None], -wh, wh)
    pdf = (
        tr_d(wh, ax, ay)
        * tr_g1(wo, ax, ay)
        * torch.abs(m.dot(wo, wh))
        / torch.clamp(torch.abs(m.cos_theta(wo)), min=1e-12)
    )
    return wh, pdf


# ---------------------------------------------------------------------------
# non-delta lobe eval / pdf / sample


def _everywhere(wo):
    return torch.ones(wo.shape[:-1], dtype=torch.bool, device=wo.device)


def lobe_f(lobe: Lobe, wo, wi):
    """(f: (N,3), present: (N,)). Masked analog of `BxDF::f` returning None."""
    k = lobe.kind
    if k in ("lambert_r", "lambert_t"):
        return lobe.albedo * float(INV_PI), _everywhere(wo)
    if k == "oren_nayar":
        ci, co = m.cos_theta(wi), m.cos_theta(wo)
        cond = ci < co
        sin_alpha = torch.where(cond, m.sin_theta(wi), m.sin_theta(wo))
        tan_beta = torch.where(cond, m.tan_theta(wo), m.tan_theta(wi))
        val = (
            lobe.on_a
            + lobe.on_b * torch.clamp(m.cos_delta_phi(wi, wo), min=0.0) * sin_alpha * tan_beta
        ) * float(INV_PI)
        return lobe.albedo * val[..., None], _everywhere(wo)
    if k == "ggx_r":
        co = torch.abs(m.cos_theta(wo))
        ci = torch.abs(m.cos_theta(wi))
        win = m.normalize(wi)
        won = m.normalize(wo)
        wh = win + won
        degenerate = (torch.abs(wh).sum(-1) == 0.0) | (co == 0.0) | (ci == 0.0)
        wo_up = torch.stack([wo[..., 0], wo[..., 1], wo[..., 2] + 1.0], dim=-1)  # wo + (0,0,1)
        wh = m.normalize(torch.where(degenerate[..., None], wo_up, wh))
        fr_cos = m.dot(win, torch.where(wh[..., 2:3] < 0, -wh, wh))
        fr = (
            torch.ones_like(fr_cos)
            if lobe.fresnel_noop
            else fresnel_dielectric(fr_cos, lobe.eta_a, lobe.eta_b)
        )
        f = lobe.albedo * (
            tr_d(wh, lobe.alpha_x, lobe.alpha_y)
            * tr_g(won, win, lobe.alpha_x, lobe.alpha_y)
            * fr
            / torch.clamp(4.0 * co * ci, min=1e-12)
        )[..., None]
        return torch.where(degenerate[..., None], 0.0, f), ~degenerate
    if k == "ggx_t":
        co = m.cos_theta(wo)
        ci = m.cos_theta(wi)
        same_side = co * ci > 0
        degenerate = (ci == 0.0) | (co == 0.0)
        eta = torch.where(co > 0, lobe.eta_b / lobe.eta_a, lobe.eta_a / lobe.eta_b)
        wh = m.normalize(wo + wi * eta[..., None])
        wh = torch.where(wh[..., 2:3] < 0, -wh, wh)
        sqrt_denom = m.dot(wo, wh) + eta * m.dot(wi, wh)
        fr = fresnel_dielectric(m.dot(wo, wh), lobe.eta_a, lobe.eta_b)
        factor = 1.0 / eta
        denom = ci * co * sqrt_denom * sqrt_denom
        val = torch.abs(
            tr_d(wh, lobe.alpha_x, lobe.alpha_y)
            * tr_g(wo, wi, lobe.alpha_x, lobe.alpha_y)
            * eta
            * eta
            * torch.abs(m.dot(wi, wh))
            * torch.abs(m.dot(wo, wh))
            * factor
            * factor
            / torch.where(denom == 0, 1.0, denom)
        )
        f = (1.0 - fr)[..., None] * lobe.albedo * val[..., None]
        present = ~same_side & ~degenerate
        return torch.where(present[..., None], f, 0.0), present
    raise ValueError(k)


def lobe_pdf(lobe: Lobe, wo, wi):
    """Reference default pdf = |cosθ|/π for every non-delta lobe. Microfacet
    lobes do NOT override pdf for eval (f_pdf) in the reference — only their
    sample_f returns the VNDF pdf — so the eval-side pdf is cosine for all
    kinds."""
    return torch.abs(m.cos_theta(wi)) * float(INV_PI)


def lobe_sample(lobe: Lobe, wo, u):
    """Sample wi from one lobe: (wi, f, pdf, present).

    Default: cosine hemisphere flipped to the lobe's side of wo
    (bxdf/mod.rs:20-37); GGX lobes use VNDF sampling (microfacet.rs:166-180,
    246-266).
    """
    k = lobe.kind
    if k in ("lambert_r", "lambert_t", "oren_nayar"):
        wi, pdf = m.cosine_sample_hemisphere(u)
        z = wi[..., 2:3]  # ≥ 0 from the sampler
        if k == "lambert_t":
            # transmit: flip to the FAR side of wo (bxdf/mod.rs:28-32)
            zt = torch.where(wo[..., 2:3] > 0, -z, z)
        else:
            # reflect: flip to wo's side (bxdf/mod.rs:23-27)
            zt = torch.where(wo[..., 2:3] < 0, -z, z)
        wi = torch.cat([wi[..., :2], zt], dim=-1)
        f, present = lobe_f(lobe, wo, wi)
        return wi, f, pdf, present
    if k == "ggx_r":
        wh, wh_pdf = tr_sample_wh(wo, u, lobe.alpha_x, lobe.alpha_y)
        dot_owh = m.dot(wo, wh)
        wi = -wo + (2.0 * dot_owh)[..., None] * wh
        ok = (wo[..., 2] != 0) & (dot_owh >= 0) & (wi[..., 2] * wo[..., 2] > 0)
        f, fp = lobe_f(lobe, wo, wi)
        pdf = wh_pdf / torch.clamp(4.0 * dot_owh, min=1e-12)
        return wi, f, torch.where(ok, pdf, 0.0), ok & fp
    if k == "ggx_t":
        wh, wh_pdf = tr_sample_wh(wo, u, lobe.alpha_x, lobe.alpha_y)
        dot_owh = m.dot(wo, wh)
        pos = m.cos_theta(wo) > 0
        eta_i = torch.where(pos, lobe.eta_a / lobe.eta_b, lobe.eta_b / lobe.eta_a)
        eta_o = torch.where(pos, lobe.eta_b / lobe.eta_a, lobe.eta_a / lobe.eta_b)
        wi, refr_ok = m.refract(wo, wh, eta_i)
        ok = (wo[..., 2] != 0) & (dot_owh >= 0) & refr_ok
        sqrt_denom = m.dot(wo, wh) + eta_o * m.dot(wi, wh)
        dwh_dwi = torch.abs(eta_o * eta_o * m.dot(wi, wh)) / torch.clamp(
            sqrt_denom * sqrt_denom, min=1e-12
        )
        f, fp = lobe_f(lobe, wo, wi)
        return wi, f, torch.where(ok, wh_pdf * dwh_dwi, 0.0), ok & fp
    raise ValueError(k)


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
