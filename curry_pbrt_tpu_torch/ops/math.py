"""Batched geometric/sampling math on SoA tensors.

Every function here is shape-polymorphic over leading batch dims: vectors are
`(..., 3)` float32 tensors, scalars `(...)`. Counterpart of the JAX
package's ops/math.py; the three-term sums are written out left to right so
the CPU and CUDA builds round identically (a 3-wide `sum` may reduce in
another order on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from curry_pbrt_tpu_torch.dtypes import INV_PI, PI

# ---------------------------------------------------------------------------
# small vector helpers


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def length_sq(v):
    return dot(v, v)


def length(v):
    return torch.sqrt(length_sq(v))


def safe_sqrt(x):
    """sqrt clamped at 0 with a NaN-free gradient at the clamp.

    `sqrt(max(x, 0))` has backward `0 · ∞ = NaN` exactly at 0 — and masked
    SoA lanes sit exactly at 0 — so route the gradient through a dummy
    branch instead (double where; torch.where has the same trap)."""
    safe = torch.where(x <= 0.0, 1.0, x)
    return torch.where(x <= 0.0, 0.0, torch.sqrt(safe))


def normalize(v):
    """Unit vector; zero vectors (masked lanes) map to zero with zero — not
    NaN — gradients."""
    l2 = length_sq(v)
    safe = torch.where(l2 == 0.0, 1.0, l2)
    return v * torch.rsqrt(safe)[..., None]


# ---------------------------------------------------------------------------
# frames


def coordinate_system(z):
    """Build (x, y) orthonormal to z (reference math/mod.rs:67-74).

    z: (..., 3) unit vectors → (x, y): each (..., 3).
    """
    zx, zy, zz = z[..., 0], z[..., 1], z[..., 2]
    use_x = torch.abs(zx) > torch.abs(zy)
    denom = torch.where(use_x, zx * zx + zz * zz, zy * zy + zz * zz)
    # zero z (masked miss lanes) → zero frame, never inf/NaN
    inv_a = torch.rsqrt(torch.where(denom == 0.0, 1.0, denom))
    zero = torch.zeros_like(zx)
    x_a = torch.stack([-zz, zero, zx], dim=-1)
    x_b = torch.stack([zero, zz, -zy], dim=-1)
    x = torch.where(use_x[..., None], x_a, x_b) * inv_a[..., None]
    y = cross(z, x)
    return x, y


def to_local(w, x, y, z):
    """World → shading-local coordinates (z = normal)."""
    return torch.stack([dot(w, x), dot(w, y), dot(w, z)], dim=-1)


def to_world(w, x, y, z):
    """Shading-local → world."""
    return x * w[..., 0:1] + y * w[..., 1:2] + z * w[..., 2:3]


# ---------------------------------------------------------------------------
# local-frame trig (z is the normal) — reference math/mod.rs:152-201


def cos_theta(w):
    return w[..., 2]


def cos2_theta(w):
    return w[..., 2] * w[..., 2]


def sin2_theta(w):
    return torch.clamp(1.0 - cos2_theta(w), min=0.0)


def sin_theta(w):
    return safe_sqrt(sin2_theta(w))


def tan_theta(w):
    return sin_theta(w) / cos_theta(w)


def tan2_theta(w):
    return sin2_theta(w) / cos2_theta(w)


def cos_phi(w):
    st = sin_theta(w)
    return torch.where(st == 0.0, 1.0,
                       torch.clamp(w[..., 0] / torch.where(st == 0, 1.0, st), -1.0, 1.0))


def sin_phi(w):
    st = sin_theta(w)
    return torch.where(st == 0.0, 0.0,
                       torch.clamp(w[..., 1] / torch.where(st == 0, 1.0, st), -1.0, 1.0))


def cos2_phi(w):
    c = cos_phi(w)
    return c * c


def sin2_phi(w):
    s = sin_phi(w)
    return s * s


def cos_delta_phi(wa, wb):
    """Azimuth-difference cosine (reference math/mod.rs:191-198)."""
    num = wa[..., 0] * wb[..., 0] + wa[..., 1] * wb[..., 1]
    den = torch.sqrt((wa[..., 0] * wa[..., 0] + wa[..., 1] * wa[..., 1])
                     * (wb[..., 0] * wb[..., 0] + wb[..., 1] * wb[..., 1]))
    return torch.clamp(num / torch.where(den == 0, 1.0, den), -1.0, 1.0)


# ---------------------------------------------------------------------------
# MIS


def power_heuristic(f, g):
    """β=2 power heuristic (reference math/mod.rs:32-34). 0/0 → 0 (masked
    lanes feed f = g = 0)."""
    f2 = f * f
    denom = f2 + g * g
    return torch.where(denom == 0.0, 0.0, f2 / torch.where(denom == 0.0, 1.0, denom))


# ---------------------------------------------------------------------------
# sampling primitives — reference math/mod.rs:98-126


def concentric_sample_disk(u):
    """u: (..., 2) in [0,1)² → (..., 2) points on the unit disk."""
    ux = 2.0 * u[..., 0] - 1.0
    uy = 2.0 * u[..., 1] - 1.0
    zero = (ux == 0.0) | (uy == 0.0)
    use_x = torch.abs(ux) > torch.abs(uy)
    safe_ux = torch.where(ux == 0, 1.0, ux)
    safe_uy = torch.where(uy == 0, 1.0, uy)
    r = torch.where(use_x, ux, uy)
    theta = torch.where(
        use_x,
        float(PI / 4.0) * (uy / safe_ux),
        float(PI / 2.0) - float(PI / 4.0) * (ux / safe_uy),
    )
    p = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    return torch.where(zero[..., None], 0.0, p)


def uniform_sample_hemisphere(u):
    """u: (..., 2) → unit vectors with z ∈ [-1, 1] (the reference samples
    the FULL sphere despite the name; sphere area sampling relies on that)."""
    z = 1.0 - 2.0 * u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = float(2.0 * PI) * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def cosine_sample_hemisphere(u):
    """u: (..., 2) → (w: (...,3), pdf: (...))."""
    d = concentric_sample_disk(u)
    z = safe_sqrt(1.0 - (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]))
    w = torch.cat([d, z[..., None]], dim=-1)
    return w, z * float(INV_PI)


def uniform_sample_triangle(u):
    """u: (..., 2) → barycentric (b0, b1): (..., 2)."""
    su0 = torch.sqrt(u[..., 0])
    return torch.stack([1.0 - su0, u[..., 1] * su0], dim=-1)


def sample_usize_remap(u, n: int):
    """Uniform index in [0, n) plus the remapped residual sample
    (reference math/mod.rs:84-90). n is static."""
    f = u * float(n)
    idx = torch.clamp(f.to(torch.int32), max=n - 1)
    return idx, f - torch.floor(f)


# ---------------------------------------------------------------------------
# spherical mappings — reference math/mod.rs:135-151


def spherical_to_normalized_phi_theta(w):
    """Unit vector → (phi/2π, theta/π) in [0,1]²; w: (...,3) → (...,2)."""
    p = torch.atan2(w[..., 1], w[..., 0])
    p = torch.where(p < 0.0, p + float(2.0 * PI), p)
    u = p * 0.5 * float(INV_PI)
    v = torch.acos(torch.clamp(w[..., 2], -1.0, 1.0)) * float(INV_PI)
    return torch.stack([u, v], dim=-1)


# ---------------------------------------------------------------------------
# refraction — reference math/mod.rs:202-211


def refract(wo, n, eta):
    """Refract wo about normal n with relative IOR eta = eta_i/eta_t.

    Returns (wi: (...,3), ok: (...) bool). Total internal reflection → ok=False.
    """
    cos_theta_o = dot(wo, n)
    sin2_theta_o = 1.0 - cos_theta_o * cos_theta_o
    sin2_theta_i = sin2_theta_o * eta * eta
    ok = sin2_theta_i <= 1.0
    cos_theta_i = safe_sqrt(1.0 - sin2_theta_i)
    wi = eta[..., None] * (-wo) + (eta * cos_theta_o - cos_theta_i)[..., None] * n
    return wi, ok


# ---------------------------------------------------------------------------
# gamma (sRGB-ish) transfer — reference math/mod.rs:51-65


def gamma_correct(f):
    return torch.where(
        f <= 0.0031308,
        12.92 * f,
        1.055 * torch.pow(torch.clamp(f, min=1e-12), 1.0 / 2.4) - 0.055,
    )


def inverse_gamma_correct(f: np.ndarray) -> np.ndarray:
    """Host-side (numpy) decode of spectrum textures. The reference divides
    by 1.05 (math/mod.rs:63) — an sRGB constant typo it applies consistently
    to loaded textures; reproduced so texture values match it."""
    return np.where(f <= 0.04045, f / 12.92, np.power((f + 0.055) / 1.05, 2.4))
