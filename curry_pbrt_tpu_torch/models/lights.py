"""Light table: SoA light arrays + batched sampling/emission ops
(counterpart of the JAX package's models/lights.py).

Every light instance is a row of a `LightArrays` table (host numpy, built by
the scene compiler); per-ray operations gather the chosen light's row and
evaluate every present type's formula under masks.

Type semantics:
  POINT     I/r² falloff, delta           (light/point.rs:28-39)
  DISTANT   fixed direction, delta        (light/distant.rs:28-35)
  AREA_TRI  diffuse emitter over a triangle (light/area.rs + triangle.rs:120-126)
  AREA_SPH  diffuse emitter over a sphere — cone sampling from outside
            (light/area.rs + sphere.rs:66-105)
  INFINITE  env-map with luminance·sinθ importance table: the tables and
            escaped-ray lookups are ported; sampling one raises
            NotImplementedError (ROADMAP.md Queue 1 item 5)

Every light's radiance/intensity is a row of params['light_L'] (L,3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX, Float, gamma
from curry_pbrt_tpu_torch.ops import math as m
from curry_pbrt_tpu_torch.ops.distribution import Distribution2D, build_distribution_2d
from curry_pbrt_tpu_torch.ops.intersect import (
    _mat3_vec,
    offset_point_by_error,
    transform_shape_point,
)
from curry_pbrt_tpu_torch.ops.math import safe_sqrt

TYPE_POINT, TYPE_DISTANT, TYPE_AREA_TRI, TYPE_AREA_SPH, TYPE_INFINITE = range(5)

_G6 = float(gamma(6))
_TWO_PI = float(np.float32(2.0 * np.pi))


class LightArrays(NamedTuple):
    """(L,) rows of host numpy arrays; unused fields hold zeros for other
    types. `on(device)` gives the same table as tensors."""

    type_id: np.ndarray  # (L,) i32
    is_delta: np.ndarray  # (L,) bool
    vec: np.ndarray  # (L,3) point position / distant unit direction
    tri_p0: np.ndarray  # (L,3) area-tri world-space vertices
    tri_p1: np.ndarray
    tri_p2: np.ndarray
    sph_o2w: np.ndarray  # (L,4,4) area-sphere object space
    sph_w2o: np.ndarray
    sph_radius: np.ndarray  # (L,)
    area: np.ndarray  # (L,) object-space area (tri or sphere)
    env_id: np.ndarray  # (L,) i32 index into the scene's env maps, -1 otherwise

    @property
    def count(self) -> int:
        return int(self.type_id.shape[0])

    def on(self, device) -> "LightArrays":
        return LightArrays(*(torch.as_tensor(a, device=device) for a in self))


@dataclass
class EnvMap:
    """One environment map (one per infinite light; its radiance tint is the
    light's row in params['light_L'])."""

    image: np.ndarray  # (H, W, 3)
    dist: Distribution2D


class LightSample(NamedTuple):
    wi: torch.Tensor  # (N,3) unit
    li: torch.Tensor  # (N,3)
    pdf: torch.Tensor  # (N,)
    present: torch.Tensor  # (N,) bool — reference's Option<Spectrum>
    vis_o: torch.Tensor  # shadow ray (o, d, t_max)
    vis_d: torch.Tensor
    vis_tmax: torch.Tensor


def build_env_distribution(image: np.ndarray) -> Distribution2D:
    """Luminance·sin θ importance table (infinite_area.rs:10-26)."""
    h = image.shape[0]
    lum = 0.212671 * image[..., 0] + 0.715160 * image[..., 1] + 0.072169 * image[..., 2]
    theta = (np.arange(h, dtype=np.float64) + 0.5) / h * np.pi
    f = lum * np.sin(theta)[:, None]
    return build_distribution_2d(f)


def types_present(type_id) -> frozenset:
    """Static set of light types in the (host) table, used to skip whole
    per-type branches."""
    return frozenset(int(t) for t in np.asarray(type_id))


def _where3(sel, a, b):
    return torch.where(sel[:, None], a, b)


def sample_li(
    lights: LightArrays,  # host table: decides which branches exist
    dev_lights: LightArrays,  # the same table as tensors on the device
    envs,
    light_L,  # (L,3) from params
    light_idx,  # (N,) int64
    p, n, p_err,  # surface shape point (N,3) each
    u2,  # (N,2)
) -> LightSample:
    """Vectorized Light::sample_li over per-ray chosen lights."""
    N = p.shape[0]
    tp = types_present(lights.type_id)
    if envs and TYPE_INFINITE in tp:
        raise NotImplementedError(
            "sampling an infinite (environment) light is not ported to "
            "curry_pbrt_tpu_torch yet (ROADMAP.md Queue 1 item 5)"
        )
    L_ = dev_lights
    t = L_.type_id[light_idx]
    L = light_L[light_idx]  # (N,3)

    z3 = torch.zeros((N, 3), dtype=torch.float32, device=p.device)
    wi, li = z3, z3
    pdf = torch.zeros((N,), dtype=torch.float32, device=p.device)
    present = torch.zeros((N,), dtype=torch.bool, device=p.device)
    # target shape point for two-point visibility rays
    to_p, to_n, to_err = z3, z3, z3
    unbounded = torch.zeros((N,), dtype=torch.bool, device=p.device)

    # ---- POINT (I/r²; delta)
    if TYPE_POINT in tp:
        lp = L_.vec[light_idx]
        d = lp - p
        d2 = m.length_sq(d)
        sel = t == TYPE_POINT
        wi_pt = m.normalize(d)
        li_pt = L / torch.clamp(d2, min=1e-20)[:, None]
        wi = _where3(sel, wi_pt, wi)
        li = _where3(sel, li_pt, li)
        pdf = torch.where(sel, 1.0, pdf)
        present = present | sel
        to_p = _where3(sel, lp, to_p)
        to_n = _where3(sel, -wi_pt, to_n)  # normal unused (err=0)

    # ---- DISTANT (delta, unbounded visibility ray)
    if TYPE_DISTANT in tp:
        sel = t == TYPE_DISTANT
        w = L_.vec[light_idx]
        wi = _where3(sel, -w, wi)
        li = _where3(sel, L, li)
        pdf = torch.where(sel, 1.0, pdf)
        present = present | sel
        unbounded = unbounded | sel

    # ---- AREA_TRI: uniform area sample → solid-angle pdf
    if TYPE_AREA_TRI in tp:
        sel = t == TYPE_AREA_TRI
        p0, p1, p2 = L_.tri_p0[light_idx], L_.tri_p1[light_idx], L_.tri_p2[light_idx]
        b = m.uniform_sample_triangle(u2)
        b0, b1 = b[:, 0:1], b[:, 1:2]
        b2 = 1.0 - b0 - b1
        sp_p = b0 * p0 + b1 * p1 + b2 * p2
        sp_n = m.normalize(m.cross(p0 - p2, p1 - p2))
        sp_err = _G6 * (torch.abs(b0 * p0) + torch.abs(b1 * p1) + torch.abs(b2 * p2))
        area = L_.area[light_idx]
        wvec = sp_p - p
        dist2 = m.length_sq(wvec)
        # default_sample_by_point (shape/mod.rs:24-41): pdf_area·dist²/(-ŵ·n),
        # no abs — replicated exactly; NaN/inf → 0
        denom = -m.dot(m.normalize(wvec), sp_n)
        pdf_tri = (1.0 / torch.clamp(area, min=1e-20)) * dist2 / torch.where(denom == 0, 1.0, denom)
        bad = (denom == 0) | (dist2 == 0) | torch.isnan(pdf_tri) | torch.isinf(pdf_tri)
        pdf_tri = torch.where(bad, 0.0, pdf_tri)
        wi = _where3(sel, m.normalize(wvec), wi)
        li = _where3(sel, L, li)  # two-sided constant (area.rs:21-23)
        pdf = torch.where(sel, pdf_tri, pdf)
        present = torch.where(sel, dist2 > 0, present)
        to_p = _where3(sel, sp_p, to_p)
        to_n = _where3(sel, sp_n, to_n)
        to_err = _where3(sel, sp_err, to_err)

    # ---- AREA_SPH: cone sampling from outside (sphere.rs:66-95), uniform
    # sphere + reprojection inside
    if TYPE_AREA_SPH in tp:
        sel = t == TYPE_AREA_SPH
        w2o, o2w = L_.sph_w2o[light_idx], L_.sph_o2w[light_idx]
        radius = L_.sph_radius[light_idx]
        p_obj = _mat3_vec(w2o, p) + w2o[:, :3, 3]
        dist2_o = m.length_sq(p_obj)
        r2 = radius * radius
        outside = dist2_o > r2

        dist = torch.sqrt(torch.clamp(dist2_o, min=1e-20))
        z_ax = p_obj / dist[:, None]
        x_ax, y_ax = m.coordinate_system(z_ax)
        sin2_max = r2 / torch.clamp(dist2_o, min=1e-20)
        cos_max = safe_sqrt(1.0 - sin2_max)
        cos_t = (1.0 - u2[:, 0]) + u2[:, 0] * cos_max
        sin_t = safe_sqrt(1.0 - cos_t * cos_t)
        phi = u2[:, 1] * _TWO_PI
        ds = dist * cos_t - safe_sqrt(r2 - dist2_o * sin_t * sin_t)
        cos_a = (dist2_o + r2 - ds * ds) / (2.0 * dist * torch.clamp(radius, min=1e-20))
        sin_a = safe_sqrt(1.0 - cos_a * cos_a)
        dvec = (
            cos_a[:, None] * z_ax
            + (sin_a * torch.cos(phi))[:, None] * x_ax
            + (sin_a * torch.sin(phi))[:, None] * y_ax
        )
        pdf_out = 1.0 / (_TWO_PI * torch.clamp(1.0 - cos_max, min=1e-12))

        d_in = m.uniform_sample_hemisphere(u2)  # full sphere (see ops.math)
        sp_obj_in = d_in * radius[:, None]
        wvec_o = sp_obj_in - p_obj
        denom_in = -m.dot(m.normalize(wvec_o), d_in)
        pdf_in = (
            (1.0 / torch.clamp(float(np.float32(4.0 * np.pi)) * r2, min=1e-20))
            * m.length_sq(wvec_o)
            / torch.where(denom_in == 0, 1.0, denom_in)
        )
        pdf_in = torch.where(
            (denom_in == 0) | torch.isnan(pdf_in) | torch.isinf(pdf_in), 0.0, pdf_in
        )

        sp_obj = _where3(outside, dvec * radius[:, None], sp_obj_in)
        n_obj = _where3(outside, dvec, d_in)
        pdf_sph = torch.where(outside, pdf_out, pdf_in)
        sp_w, sn_w, serr_w = transform_shape_point(o2w, w2o, sp_obj, n_obj)
        wvec = sp_w - p
        dist2w = m.length_sq(wvec)
        ok_sph = (dist2w > 0) & (pdf_sph != 0)
        wi = _where3(sel, m.normalize(wvec), wi)
        li = _where3(sel, L, li)
        pdf = torch.where(sel, pdf_sph, pdf)
        present = torch.where(sel, ok_sph, present)
        to_p = _where3(sel, sp_w, to_p)
        to_n = _where3(sel, sn_w, to_n)
        to_err = _where3(sel, serr_w, to_err)

    # ---- visibility rays
    # bounded: two-point ray with both endpoints offset (VisibilityTester::new)
    o_b = offset_point_by_error(p, n, p_err, to_p - p)
    to_b = offset_point_by_error(to_p, to_n, to_err, o_b - to_p)
    d_b = to_b - o_b
    t_b = torch.full((N,), float(Float(1.0 - 1e-5)), dtype=torch.float32, device=p.device)
    # unbounded: origin-offset directional ray (VisibilityTester::new_od)
    o_u = offset_point_by_error(p, n, p_err, wi)
    vis_o = _where3(unbounded, o_u, o_b)
    vis_d = _where3(unbounded, wi, d_b)
    vis_t = torch.where(unbounded, float(FLOAT_MAX), t_b)

    return LightSample(wi, li, pdf, present, vis_o, vis_d, vis_t)


def eval_env(env: EnvMap, w):
    """Escaped-ray radiance lookup (infinite_area.rs:35-39 + the image
    evaluate v-flip pair, which nets to row=θ, col=φ)."""
    uv = m.spherical_to_normalized_phi_theta(m.normalize(w))
    img = torch.as_tensor(env.image, device=w.device)
    h, wd = img.shape[0], img.shape[1]
    y = torch.clamp((uv[..., 1] * h).to(torch.int32), 0, h - 1).long()
    x = torch.clamp((uv[..., 0] * wd).to(torch.int32), 0, wd - 1).long()
    return img[y, x]


def le_out_scene_total(lights: LightArrays, envs, light_L, d):
    """Σ over lights of le_out_scene(ray) — only infinite lights contribute
    (path.rs:24-28), each through its own map. d: (N,3) → (N,3)."""
    out = torch.zeros(d.shape[:-1] + (3,), dtype=torch.float32, device=d.device)
    for eid, env in enumerate(envs or ()):
        is_mine = (lights.type_id == TYPE_INFINITE) & (lights.env_id == eid)
        tint = light_L[torch.as_tensor(np.nonzero(is_mine)[0], device=d.device)].sum(dim=0)
        out = out + eval_env(env, d) * tint[None, :]
    return out


def le_emitted(light_L, light_idx):
    """Surface emission of a hit area-light primitive — two-sided constant L
    (area.rs:21-23). light_idx: (N,) (−1 → none)."""
    L = light_L[torch.clamp(light_idx, min=0)]
    return torch.where((light_idx >= 0)[:, None], L, 0.0)


def le_pdf(lights: LightArrays, dev_lights: LightArrays, light_idx, ref_p, hit_p):
    """Light::pdf → Shape::by_point_pdf for area lights: solid-angle density
    of sampling the direction that produced this hit.

    tri: default_by_point_pdf (shape/mod.rs:42-52, WITH abs in denominator),
    the light's own triangle supplying the surface normal; sphere: cone pdf
    outside (sphere.rs:96-105), default inside.
    """
    N = ref_p.shape[0]
    tp = types_present(lights.type_id)
    safe = torch.clamp(light_idx, min=0)
    L_ = dev_lights
    t = L_.type_id[safe]
    pdf = torch.zeros((N,), dtype=torch.float32, device=ref_p.device)

    if TYPE_AREA_TRI in tp:
        sel = t == TYPE_AREA_TRI
        area = L_.area[safe]
        tp0, tp1, tp2 = L_.tri_p0[safe], L_.tri_p1[safe], L_.tri_p2[safe]
        hit_n = m.normalize(m.cross(tp0 - tp2, tp1 - tp2))
        dvec = ref_p - hit_p
        dist2 = m.length_sq(dvec)
        dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
        denom = torch.abs(m.dot(dvec / dist[:, None], hit_n)) * area
        pdf_tri = dist2 / torch.where(denom == 0, 1.0, denom)
        pdf_tri = torch.where(
            (denom == 0) | torch.isnan(pdf_tri) | torch.isinf(pdf_tri), 0.0, pdf_tri
        )
        pdf = torch.where(sel, pdf_tri, pdf)

    if TYPE_AREA_SPH in tp:
        sel = t == TYPE_AREA_SPH
        w2o = L_.sph_w2o[safe]
        radius = L_.sph_radius[safe]
        p_obj = _mat3_vec(w2o, ref_p) + w2o[:, :3, 3]
        dist2_o = m.length_sq(p_obj)
        r2 = radius * radius
        outside = dist2_o >= r2
        sin2_max = r2 / torch.clamp(dist2_o, min=1e-20)
        cos_max = safe_sqrt(1.0 - sin2_max)
        pdf_cone = 1.0 / (_TWO_PI * torch.clamp(1.0 - cos_max, min=1e-12))
        area_s = float(np.float32(4.0 * np.pi)) * r2
        hp_obj = _mat3_vec(w2o, hit_p) + w2o[:, :3, 3]
        dvec_o = p_obj - hp_obj
        dist2_i = m.length_sq(dvec_o)
        dist_i = torch.sqrt(torch.clamp(dist2_i, min=1e-20))
        n_obj = m.normalize(hp_obj)
        denom_i = torch.abs(m.dot(dvec_o / dist_i[:, None], n_obj)) * area_s
        pdf_in = dist2_i / torch.where(denom_i == 0, 1.0, denom_i)
        pdf_in = torch.where((denom_i == 0) | torch.isnan(pdf_in) | torch.isinf(pdf_in), 0.0, pdf_in)
        pdf = torch.where(sel, torch.where(outside, pdf_cone, pdf_in), pdf)

    return torch.where(light_idx >= 0, pdf, 0.0)
