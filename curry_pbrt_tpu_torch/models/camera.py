"""Perspective camera (+ thin lens) as a batched ray generator.

The reference composes PerspectiveCamera → LensCamera → TransformCamera
decorators. Here everything collapses at scene compile into two matrices —
raster→camera (projective) and camera→world — and `generate_rays` maps a
film-point batch to a world-space ray batch. Counterpart of the JAX
package's models/camera.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from curry_pbrt_tpu_torch.dtypes import Float
from curry_pbrt_tpu_torch.ops import math as m
from curry_pbrt_tpu_torch.ops import transform as tf


@dataclass
class Camera:
    raster_to_camera: np.ndarray  # (4,4) projective
    camera_to_world: np.ndarray  # (4,4) rigid
    resolution: tuple  # (xres, yres)
    lens_radius: float = 0.0
    focal_distance: float = 1e6

    @property
    def has_lens(self) -> bool:
        return self.lens_radius > 0.0


def make_perspective_camera(
    fov: float,
    resolution,
    camera_to_world: Optional[np.ndarray] = None,
    lens_radius: float = 0.0,
    focal_distance: float = 1e6,
) -> Camera:
    """Matrix chain per perspective.rs:10-52: screen window from aspect,
    screen→raster flip-y scale, camera→screen perspective(near=1e-2,
    far=1000)."""
    xres, yres = int(resolution[0]), int(resolution[1])
    aspect = xres / yres
    if aspect > 1.0:
        smin = np.array([-aspect, -1.0])
        smax = np.array([aspect, 1.0])
    else:
        smin = np.array([-1.0, -1.0 / aspect])
        smax = np.array([1.0, 1.0 / aspect])
    diag = smax - smin
    screen_to_raster = tf.compose(
        tf.scale([xres, yres, 1.0]),
        tf.compose(
            tf.scale([1.0 / diag[0], -1.0 / diag[1], 1.0]),
            tf.translate([-smin[0], -smax[1], 0.0]),
        ),
    )
    camera_to_screen = tf.perspective(fov, 1e-2, 1000.0)
    camera_to_raster = tf.compose(screen_to_raster, camera_to_screen)
    return Camera(
        raster_to_camera=np.linalg.inv(camera_to_raster.astype(np.float64)).astype(Float),
        camera_to_world=(
            np.eye(4, dtype=Float) if camera_to_world is None else camera_to_world.astype(Float)
        ),
        resolution=(xres, yres),
        lens_radius=float(lens_radius),
        focal_distance=float(focal_distance),
    )


def _affine(mat, v, with_w: float):
    """Rows of `mat` (numpy (4,4)) applied to (N,3) tensor v as
    mat[:3,:3]·v (+ with_w·mat[:3,3]) with sums written left to right —
    a 4-wide matmul may reduce in another order on the card."""
    cols = []
    for i in range(3):
        acc = v[:, 0] * float(mat[i, 0]) + v[:, 1] * float(mat[i, 1]) + v[:, 2] * float(mat[i, 2])
        if with_w:
            acc = acc + float(mat[i, 3])
        cols.append(acc)
    return torch.stack(cols, dim=-1)


def generate_rays(cam: Camera, film_xy, lens_u=None):
    """film_xy: (N,2) continuous raster coords → (o, d): (N,3) world rays.

    PerspectiveCamera::generate_ray (perspective.rs:47-52): unproject
    (x, y, 0) to camera space, ray from origin along the normalized point;
    LensCamera (lens.rs:24-33) refocuses through a sampled lens point;
    TransformCamera (camera/mod.rs:66-68) moves rays to world.
    """
    r2c = cam.raster_to_camera
    fx, fy = film_xy[:, 0], film_xy[:, 1]
    # (x, y, 0, 1) · r2cᵀ — the z column multiplies 0 and the w column 1
    pc = [
        fx * float(r2c[i, 0]) + fy * float(r2c[i, 1]) + float(r2c[i, 3])
        for i in range(4)
    ]
    pc3 = torch.stack(pc[:3], dim=-1) / pc[3][:, None]
    d = m.normalize(pc3)
    o = torch.zeros_like(d)

    if cam.has_lens and lens_u is not None:
        lens = float(cam.lens_radius) * m.concentric_sample_disk(lens_u)
        ft = float(Float(cam.focal_distance)) / d[:, 2]
        focus = o + ft[:, None] * d
        o = torch.cat([lens, torch.zeros_like(lens[:, :1])], dim=-1)
        d = m.normalize(focus - o)

    c2w = cam.camera_to_world
    return _affine(c2w, o, 1.0), _affine(c2w, d, 0.0)


def world_to_raster(cam: Camera, p_world):
    """Project world points to raster (for the frustum clipper)."""
    w2c = np.linalg.inv(cam.camera_to_world.astype(np.float64))
    c2r = np.linalg.inv(cam.raster_to_camera.astype(np.float64))
    ph = np.concatenate([p_world, np.ones((len(p_world), 1))], axis=-1)
    pc = ph @ w2c.T
    pr = pc @ c2r.T
    w = pr[:, 3:4]
    return pr[:, :3] / np.where(w == 0, 1.0, w)


def clip_primitive_bound(cam: Camera, bound_min, bound_max, is_light: bool) -> bool:
    """Frustum cull: True if ALL 8 AABB corners are outside the raster
    volume, for non-emissive primitives only (perspective.rs:54-78)."""
    if is_light:
        return False
    corners = np.array(
        [
            [
                (bound_min, bound_max)[(i >> k) & 1][k]
                for k in range(3)
            ]
            for i in range(8)
        ]
    )
    pr = world_to_raster(cam, corners)
    xres, yres = cam.resolution
    clip = (
        (pr[:, 2] < 0)
        | (pr[:, 0] >= xres)
        | (pr[:, 0] < 0)
        | (pr[:, 1] >= yres)
        | (pr[:, 1] < 0)
    )
    return bool(np.all(clip))
