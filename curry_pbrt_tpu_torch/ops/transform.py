"""4×4 transforms.

Host-side (numpy) constructors used by the scene compiler to bake
object-to-world transforms into world-space geometry, plus appliers that
take numpy arrays or torch tensors (copied from the JAX package's
ops/transform.py; only the appliers' array dispatch changed).

Reference semantics: reference src/geometry/transform.rs (matrix + inverse
pair; look_at builds camera-to-world; rotate stores the matrix that acts on
ROW vectors — the transpose of the usual column-vector rotation).
"""

from __future__ import annotations

import numpy as np
import torch

from curry_pbrt_tpu_torch.dtypes import Float


def identity() -> np.ndarray:
    return np.eye(4, dtype=Float)


def translate(delta) -> np.ndarray:
    m = np.eye(4, dtype=Float)
    m[:3, 3] = np.asarray(delta, dtype=Float)
    return m


def scale(s) -> np.ndarray:
    m = np.eye(4, dtype=Float)
    s = np.asarray(s, dtype=Float)
    m[0, 0], m[1, 1], m[2, 2] = s[0], s[1], s[2]
    return m


def rotate(angle_deg, axis) -> np.ndarray:
    """Rotation about `axis` by `angle_deg`, as the reference's Rotate
    directive builds it (transform.rs:38-62): the transpose of the standard
    column-vector form."""
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    rad = np.deg2rad(float(angle_deg))
    s, c = np.sin(rad), np.cos(rad)
    x, y, z = a
    m = np.eye(4, dtype=np.float64)
    m[0, 0] = x * x + (1 - x * x) * c
    m[0, 1] = x * y * (1 - c) + z * s
    m[0, 2] = x * z * (1 - c) - y * s
    m[1, 0] = x * y * (1 - c) - z * s
    m[1, 1] = y * y + (1 - y * y) * c
    m[1, 2] = y * z * (1 - c) + x * s
    m[2, 0] = x * z * (1 - c) + y * s
    m[2, 1] = y * z * (1 - c) - x * s
    m[2, 2] = z * z + (1 - z * z) * c
    return m.astype(Float)


def look_at(pos, look, up) -> np.ndarray:
    """World-to-camera placement: the matrix the reference calls `m` (the
    inverse of camera-to-world, transform.rs:28-37)."""
    pos = np.asarray(pos, dtype=np.float64)
    look = np.asarray(look, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    d = look - pos
    d = d / np.linalg.norm(d)
    upn = up / np.linalg.norm(up)
    right = np.cross(upn, d)
    right = right / np.linalg.norm(right)
    new_up = np.cross(d, right)
    m_inv = np.eye(4, dtype=np.float64)
    m_inv[:3, 0] = right
    m_inv[:3, 1] = new_up
    m_inv[:3, 2] = d
    m_inv[:3, 3] = pos
    return np.linalg.inv(m_inv).astype(Float)


def perspective(fov_deg, near, far) -> np.ndarray:
    """Camera-to-screen projective matrix (transform.rs:103-124)."""
    inv_tan = 1.0 / np.tan(np.deg2rad(float(fov_deg)) / 2.0)
    t = far / (far - near)
    m = np.zeros((4, 4), dtype=Float)
    m[0, 0] = inv_tan
    m[1, 1] = inv_tan
    m[2, 2] = t
    m[2, 3] = -t * near
    m[3, 2] = 1.0
    return m


def compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """`compose(a, b)` applies b first, then a — matrix product a @ b."""
    return (a.astype(np.float64) @ b.astype(np.float64)).astype(Float)


def inverse(m: np.ndarray) -> np.ndarray:
    return np.linalg.inv(m.astype(np.float64)).astype(Float)


# ---------------------------------------------------------------------------
# appliers — numpy arrays or torch tensors; m is (4,4), x is (..., 3)


def _like(m, x):
    """m as an array of x's kind (a tensor on x's device for tensor x)."""
    if isinstance(x, torch.Tensor):
        return torch.as_tensor(np.asarray(m), dtype=x.dtype, device=x.device)
    return m


def apply_p(m, p):
    """Transform points (with translation + homogeneous divide)."""
    projective = bool(np.asarray(m)[3, :3].any() or np.asarray(m)[3, 3] != 1)
    xp = torch if isinstance(p, torch.Tensor) else np
    m = _like(m, p)
    r = p @ m[:3, :3].T + m[:3, 3]
    if not projective:
        return r
    w = p @ m[3, :3].T + m[3, 3]
    return r / xp.where(w == 0, 1.0, w)[..., None]


def apply_v(m, v):
    """Transform vectors (rotation/scale only)."""
    return v @ _like(m, v)[:3, :3].T


def apply_n(m_inv, n):
    """Transform normals by the inverse-transpose (pass the INVERSE matrix);
    re-normalized (reference geometry/normal.rs:32-37)."""
    r = n @ _like(m_inv, n)[:3, :3]
    if isinstance(r, torch.Tensor):
        return r / torch.linalg.norm(r, dim=-1, keepdim=True)
    return r / np.linalg.norm(r, axis=-1, keepdims=True)


def has_scale(m) -> bool:
    for axis in np.eye(3, dtype=Float):
        l = np.linalg.norm(apply_v(m, axis))
        if l < 0.999 or l > 1.001:
            return True
    return False
