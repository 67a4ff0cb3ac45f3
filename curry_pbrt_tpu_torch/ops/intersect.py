"""Batched ray–primitive intersection math (counterpart of the JAX package's
ops/intersect.py).

SoA geometry tables, the watertight ray–triangle test, the stable sphere
quadratic, winner-only hit attributes and error-offset ray spawning. The
traversal itself runs in the CUDA kernels of ops/kernels/; this module holds
the per-pair math they share with their plain versions, and the attribute
pass that follows them.

Triangle test: watertight Möller (translate–permute–shear, edge functions,
conservative error rejection) as the reference's
geometry/shape/triangle.rs:194-262 (pbrt §3.9). Sphere test: object-space
quadratic in the numerically stable q-form.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX, gamma
from curry_pbrt_tpu_torch.ops.math import cross, dot, length, normalize, safe_sqrt

_G2 = float(gamma(2))
_G3 = float(gamma(3))
_G5 = float(gamma(5))
_G7 = float(gamma(7))
_FMAX = float(FLOAT_MAX)


class TriangleArrays(NamedTuple):
    """World-space triangle soup (transforms baked by the scene compiler).

    p0/p1/p2: (T, 3) f32; prim: (T,) i32 primitive id, -1 for padding.
    The scene compiler returns numpy arrays; the aggregate holds tensors.
    """

    p0: object
    p1: object
    p2: object
    prim: object

    @property
    def count(self) -> int:
        return self.p0.shape[0]


class SphereArrays(NamedTuple):
    """Spheres with per-sphere object spaces.

    o2w/w2o: (S, 4, 4); radius: (S,); prim: (S,) i32 (-1 padding).
    """

    o2w: object
    w2o: object
    radius: object
    prim: object

    @property
    def count(self) -> int:
        return self.o2w.shape[0]


class Hit(NamedTuple):
    """Per-ray hit record (miss ⇔ prim < 0)."""

    t: torch.Tensor  # (N,)
    prim: torch.Tensor  # (N,) i32
    p: torch.Tensor  # (N, 3)
    n: torch.Tensor  # (N, 3) geometric normal (unit)
    uv: torch.Tensor  # (N, 2)
    p_error: torch.Tensor  # (N, 3) conservative fp bound on p

    @property
    def valid(self):
        return self.prim >= 0


# ---------------------------------------------------------------------------
# watertight triangle test


def _argmax3(ad):
    """First-max index over the last (size-3) axis."""
    ax, ay, az = ad[..., 0], ad[..., 1], ad[..., 2]
    return torch.where(
        (ax >= ay) & (ax >= az), 0, torch.where(ay >= az, 1, 2)
    ).to(torch.int32)


def _select_by_kz(kz, a, b, c):
    return torch.where(kz == 0, a, torch.where(kz == 1, b, c))


def permute_by_kz(v, kz):
    """Components (v[kx], v[ky], v[kz]) with kx=(kz+1)%3, ky=(kz+2)%3 — the
    watertight test's axis permutation (triangle.rs:199-205), as selects."""
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
    return (
        _select_by_kz(kz, v1, v2, v0),
        _select_by_kz(kz, v2, v0, v1),
        _select_by_kz(kz, v0, v1, v2),
    )


def watertight_core(o, kz, sx, sy, sz, t_max, p0, p1, p2, with_bary: bool = True):
    """Watertight Möller test on broadcast-compatible batches.

    o: (..., 3) ray origins; kz: (...) dominant ray axis (from `ray_shear`);
    sx/sy/sz: (...) shear factors; t_max: (...); p0/p1/p2: (..., 3)
    triangle vertices. Returns (t, b: (...,3) barycentrics — None when
    with_bary=False — , ok); t is FLOAT_MAX where not ok.
    """

    def prep(v):
        return permute_by_kz(v - o, kz)

    p0t, p1t, p2t = prep(p0), prep(p1), prep(p2)

    def shear_xy(p):
        return p[0] + sx * p[2], p[1] + sy * p[2]

    x0, y0 = shear_xy(p0t)
    x1, y1 = shear_xy(p1t)
    x2, y2 = shear_xy(p2t)
    e0 = x1 * y2 - y1 * x2
    e1 = x2 * y0 - y2 * x0
    e2 = x0 * y1 - y0 * x1
    same_side = ~(((e0 < 0) | (e1 < 0) | (e2 < 0)) & ((e0 > 0) | (e1 > 0) | (e2 > 0)))
    det = e0 + e1 + e2
    z0 = p0t[2] * sz
    z1 = p1t[2] * sz
    z2 = p2t[2] * sz
    t_scaled = e0 * z0 + e1 * z1 + e2 * z2
    in_range = torch.where(
        det < 0,
        (t_scaled < 0) & (t_scaled >= t_max * det),
        (t_scaled > 0) & (t_scaled <= t_max * det),
    )
    safe_det = torch.where(det == 0, 1.0, det)
    inv_det = 1.0 / safe_det
    t = t_scaled * inv_det

    # conservative fp-error rejection (triangle.rs:243-257)
    max_zt = torch.maximum(torch.abs(z0), torch.maximum(torch.abs(z1), torch.abs(z2)))
    max_xt = torch.maximum(torch.abs(x0), torch.maximum(torch.abs(x1), torch.abs(x2)))
    max_yt = torch.maximum(torch.abs(y0), torch.maximum(torch.abs(y1), torch.abs(y2)))
    delta_z = _G3 * max_zt
    delta_x = _G5 * (max_xt + max_zt)
    delta_y = _G5 * (max_yt + max_zt)
    delta_e = 2.0 * (_G2 * max_xt * max_yt + delta_y * max_xt + delta_x * max_yt)
    max_e = torch.maximum(torch.abs(e0), torch.maximum(torch.abs(e1), torch.abs(e2)))
    delta_t = (
        3.0 * (_G3 * max_e * max_zt + delta_e * max_zt + delta_z * max_e) * torch.abs(inv_det)
    )

    ok = same_side & (det != 0) & in_range & (t > delta_t)
    b = (
        torch.stack([e0 * inv_det, e1 * inv_det, e2 * inv_det], dim=-1)
        if with_bary
        else None
    )
    return torch.where(ok, t, _FMAX), b, ok


def ray_shear(d):
    """Precompute (kz, sx, sy, sz) for the watertight test. d: (N,3)."""
    kz = _argmax3(torch.abs(d))
    dx, dy, dz = permute_by_kz(d, kz)
    dz = torch.where(dz == 0, 1.0, dz)  # degenerate (masked) lanes only
    return kz, -dx / dz, -dy / dz, 1.0 / dz


def triangle_winner_attributes(o, d, t_max, tri_idx, tris: TriangleArrays):
    """Re-run the watertight test for each ray's WINNING triangle — O(N) —
    and derive (p, n, uv, p_error) from the one vertex gather.

    Default uv chart is (0,0),(1,0),(1,1) — the reference's parsers never
    populate uvs (triangle.rs:69-77). p_error is the γ₇ barycentric bound
    (triangle.rs:259-261)."""
    idx = tri_idx.long()
    p0, p1, p2 = tris.p0[idx], tris.p1[idx], tris.p2[idx]
    kz, sx, sy, sz = ray_shear(d)
    _t, b, _ok = watertight_core(o, kz, sx, sy, sz, t_max, p0, p1, p2)
    b0, b1, b2 = b[:, 0:1], b[:, 1:2], b[:, 2:3]
    p = b0 * p0 + b1 * p1 + b2 * p2
    n = normalize(cross(p0 - p2, p1 - p2))
    uv = torch.cat([b[:, 1:2] + b[:, 2:3], b[:, 2:3]], dim=-1)
    p_error = _G7 * (torch.abs(b0 * p0) + torch.abs(b1 * p1) + torch.abs(b2 * p2))
    return p, n, uv, p_error


# ---------------------------------------------------------------------------
# sphere test


def _mat3_vec(mats, v):
    """Σ_j mats[..., i, j]·v[..., j] for i < 3, summed left to right.
    mats: (..., 4, 4) broadcast against v: (..., 3)."""
    return torch.stack(
        [
            mats[..., i, 0] * v[..., 0] + mats[..., i, 1] * v[..., 1] + mats[..., i, 2] * v[..., 2]
            for i in range(3)
        ],
        dim=-1,
    )


def _to_object(sph: SphereArrays, o, d):
    """Transform rays into every sphere's object space: o/d (N,3) →
    (N,S,3)."""
    w2o = sph.w2o[None]  # (1,S,4,4)
    o_obj = _mat3_vec(w2o, o[:, None, :]) + sph.w2o[None, :, :3, 3]
    d_obj = _mat3_vec(w2o, d[:, None, :])
    return o_obj, d_obj


def sphere_quadratic(o_obj, d_obj, radius, t_max):
    """Solve |o + t d|² = r² with the stable q-form: the small root is
    recovered as c/q, and the discriminant uses the geometric perpendicular
    distance (stable for grazing rays). Returns (t, ok) with the reference's
    root pick (t0 if ≥ 0 else t1) and range tests (sphere.rs:111-132)."""
    a = dot(d_obj, d_obj)
    safe_a = torch.where(a == 0, 1.0, a)
    b_half = dot(o_obj, d_obj)
    c = dot(o_obj, o_obj) - radius * radius
    t_center = -b_half / safe_a
    perp = o_obj + t_center[..., None] * d_obj
    perp2 = dot(perp, perp)
    r2 = radius * radius
    disc_ok = (perp2 <= r2) & (a > 0)
    s = safe_sqrt(a * (r2 - perp2))
    sgn = torch.where(b_half >= 0, 1.0, -1.0)
    q = -(b_half + sgn * s)
    safe_q = torch.where(q == 0, 1.0, q)
    r1 = q / safe_a
    r2_ = torch.where(q == 0, r1, c / safe_q)
    t0 = torch.minimum(r1, r2_)
    t1 = torch.maximum(r1, r2_)
    t = torch.where(t0 >= 0.0, t0, t1)
    ok = disc_ok & (t0 <= t_max) & (t1 >= 0.0) & (t <= t_max)
    return torch.where(ok, t, _FMAX), ok


def sphere_intersect_t(o, d, t_max, sph: SphereArrays):
    """Dense (N × S) sphere test → (t: (N,S), ok: (N,S))."""
    o_obj, d_obj = _to_object(sph, o, d)
    t, ok = sphere_quadratic(o_obj, d_obj, sph.radius[None, :], t_max[:, None])
    ok = ok & (sph.prim[None, :] >= 0)
    return torch.where(ok, t, _FMAX), ok


def sphere_hit_attributes(sph_idx, t, o, d, sph: SphereArrays):
    """Hit attributes for per-ray winning spheres (object-space reproject,
    uv from spherical — sphere.rs:14-18,41-52 — then to world with the
    ShapePoint error bound, shape/mod.rs:135-160)."""
    idx = sph_idx.long()
    w2o, o2w, radius = sph.w2o[idx], sph.o2w[idx], sph.radius[idx]
    o_obj = _mat3_vec(w2o, o) + w2o[:, :3, 3]
    d_obj = _mat3_vec(w2o, d)
    p_obj = o_obj + t[:, None] * d_obj
    p_obj = p_obj * (radius / torch.clamp(length(p_obj), min=1e-30))[:, None]
    n_obj = normalize(p_obj)
    uv = sphere_uv(p_obj, radius)
    p, n, p_error = transform_shape_point(o2w, w2o, p_obj, n_obj)
    return p, n, uv, p_error


def sphere_uv(p_obj, radius):
    u = (torch.atan2(p_obj[..., 1], p_obj[..., 0]) + float(np.float32(np.pi))) * float(
        np.float32(0.5 / np.pi)
    )
    v = torch.acos(torch.clamp(p_obj[..., 2] / radius, -1.0, 1.0)) * float(
        np.float32(1.0 / np.pi)
    )
    return torch.stack([u, v], dim=-1)


def transform_shape_point(o2w, w2o, p_obj, n_obj):
    """Object-space surface point + normal → world. Normal via the
    inverse-transpose (normal.rs:32-37, renormalized); the point error bound
    is γ₃ · |M|·|p| per row (ShapePoint::apply, shape/mod.rs:135-160).
    o2w/w2o: (N,4,4); p_obj/n_obj: (N,3)."""
    p = _mat3_vec(o2w, p_obj) + o2w[:, :3, 3]
    n = normalize(_mat3_vec(w2o.transpose(-1, -2), n_obj))
    p_error = _G3 * (_mat3_vec(torch.abs(o2w), torch.abs(p_obj)) + torch.abs(o2w[:, :3, 3]))
    return p, n, p_error


# ---------------------------------------------------------------------------
# error-offset ray spawning — reference shape/mod.rs:119-126, ray.rs:27-36


def offset_point_by_error(p, n, p_error, w):
    """Offset p along ±n by the error bound, sign chosen toward w."""
    d = dot(torch.abs(n), p_error)
    offset = n * d[..., None]
    flip = (dot(w, n) < 0.0)[..., None]
    return p + torch.where(flip, -offset, offset)


def spawn_ray(p, n, p_error, d):
    """Continuation ray from a surface point (Ray::new_shape_point_d)."""
    return offset_point_by_error(p, n, p_error, d), d
