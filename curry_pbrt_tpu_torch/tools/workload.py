"""The per-bounce traversal workload the probe tools share.

One chunk of camera rays, strided over the whole image, then, bounce after
bounce, cosine-distributed continuations from the real hit normals (a
stand-in for the BSDF mix), with dead-lane masking: a lane that missed gets
t_max 0 from then on, as the integrators give it. Each bounce's closest hit
comes from K1 (tri_closest_hit_tables; its plain version on the CPU) over
the render path's own tables (aggregate.plan_tri_kernel).

The JAX package repeats this code in three tools (tools/roofline.py:106-162,
tools/probe_group_kernel.py:130-189, tools/probe_granularity.py:77ff). With
n_rays at most the image's pixel count the camera rays are theirs (one per
pixel, strided); beyond it each pixel gets several jittered samples,
pixel-major, as the renderer lays out its spp (a 512² scene at the render
path's 4,194,304-ray chunk is 16 samples per pixel).

Random numbers come from an explicit torch.Generator seeded with `seed`
(they are not the JAX package's); a test passes numpy draws as `jitter` and
`uniforms` to feed both packages the same numbers.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from curry_pbrt_tpu_torch.models.camera import generate_rays
from curry_pbrt_tpu_torch.ops import intersect as isect
from curry_pbrt_tpu_torch.ops import math as m
from curry_pbrt_tpu_torch.ops.kernels.aggregate import plan_tri_kernel
from curry_pbrt_tpu_torch.ops.kernels.intersect_kernel import DeviceTables
from curry_pbrt_tpu_torch.sceneio.compiler import Scene, compile_scene_file

SCENES = Path(__file__).resolve().parents[2] / "scenes"
UNBOUNDED = 1e30  # t_max of a live lane, as the JAX tools use


def load_scene(name) -> Scene:
    """A scene by path, or by file name under the repository's scenes/."""
    path = Path(name)
    return compile_scene_file(path if path.exists() else SCENES / name)


def camera_pixels(scene: Scene, n_rays: int) -> np.ndarray:
    """(n_rays, 2) float32 integer pixel coordinates: a stride over the
    whole image (the first rows alone are background in the mesh scenes),
    or, beyond the pixel count, every pixel repeated pixel-major, as evenly
    as n_rays allows."""
    xres, yres = scene.settings.resolution
    ys, xs = np.mgrid[0:yres, 0:xres]
    px_all = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    if n_rays <= len(px_all):
        return px_all[::max(len(px_all) // n_rays, 1)][:n_rays]
    return px_all[np.arange(n_rays, dtype=np.int64) * len(px_all) // n_rays]


@dataclass
class Bounce:
    """One bounce's traversal inputs and K1's closest hit on them."""

    index: int
    o: torch.Tensor  # (N, 3)
    d: torch.Tensor  # (N, 3)
    t_max: torch.Tensor  # (N,): UNBOUNDED on live lanes, 0 on dead ones
    t: torch.Tensor  # (N,) closest t, FLOAT_MAX on a miss
    row: torch.Tensor  # (N,) int32 table row, -1 on a miss
    active: int  # live lanes

    @property
    def hit(self):
        return self.row >= 0


class Workload:
    """A scene's render-path tables on `device` and the bounce generator."""

    def __init__(self, scene: Scene, device, tables: Optional[DeviceTables] = None):
        self.scene = scene
        self.device = torch.device(device)
        self.view = np.asarray(scene.camera.camera_to_world)[:3, 3]
        self.host = plan_tri_kernel(scene.tris, self.view)
        self.tables = tables or DeviceTables(self.host, self.device)
        as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=self.device)  # noqa: E731
        # kernel rows → the permuted triangle table (the winner attributes)
        self.tris = isect.TriangleArrays(as_t(self.host.p0), as_t(self.host.p1),
                                         as_t(self.host.p2), as_t(self.host.prim))

    def camera(self, n_rays: int, jitter=None, generator=None):
        """Camera rays (o, d) through camera_pixels + jitter in [-0.5, 0.5)²."""
        px = torch.as_tensor(camera_pixels(self.scene, n_rays), device=self.device)
        if jitter is None:
            jitter = torch.rand(px.shape, generator=generator, device=self.device) - 0.5
        else:
            jitter = torch.as_tensor(np.asarray(jitter, np.float32), device=self.device)
        return generate_rays(self.scene.camera, px + jitter, None)

    def continuation(self, b: Bounce, u2):
        """The next bounce's (o, d): a cosine direction around the hit
        normal from the offset hit point; missed lanes keep their rays."""
        hit = b.hit
        safe = torch.clamp(b.row, 0, self.tris.count - 1).long()
        hp, hn, _uv, herr = isect.triangle_winner_attributes(b.o, b.d, b.t_max, safe, self.tris)
        local, _pdf = m.cosine_sample_hemisphere(u2)
        fx, fy = m.coordinate_system(hn)
        nd = m.to_world(local, fx, fy, hn)
        o = torch.where(hit[:, None], isect.offset_point_by_error(hp, hn, herr, nd), b.o)
        d = torch.where(hit[:, None], nd, b.d)
        return o, d

    def bounces(self, n_rays: int, depth: int, seed: int = 0, jitter=None,
                uniforms: Optional[Sequence] = None) -> Iterator[Bounce]:
        """Yields `depth` Bounces of n_rays rays. jitter: (n_rays, 2) camera
        jitter in [-0.5, 0.5); uniforms: per bounce an (n_rays, 2) draw in
        [0, 1) for the continuation (numpy or tensors); both drawn from a
        torch.Generator seeded with `seed` when None."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        o, d = self.camera(n_rays, jitter, gen)
        n = o.shape[0]
        active = torch.ones((n,), dtype=torch.bool, device=self.device)
        for k in range(depth):
            t_max = torch.where(active, UNBOUNDED, 0.0)
            t, row = self.tables.closest(o, d, t_max)
            b = Bounce(k, o, d, t_max, t, row, int(active.sum()))
            yield b
            if uniforms is None:
                u2 = torch.rand((n, 2), generator=gen, device=self.device)
            else:
                u2 = torch.as_tensor(np.asarray(uniforms[k], np.float32), device=self.device)
            o, d = self.continuation(b, u2)
            active = active & b.hit
