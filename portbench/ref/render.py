"""The reference's renders and train steps: the port's plain render path
(render._chunk_sample_radiance, the box film, the sub-chunked MSE step)
over every-ray-against-every-primitive intersection.

The dense tests run over the live rays alone (t_max > 0), in blocks of at
most PAIRS_PER_BLOCK ray × primitive pairs, so that a 10k-triangle mesh
fits; a dead ray's result is a miss, as the dense test gives it. Each ray
depends only on its pixel and sample, so any set of pixels can be rendered
on its own: the benchmark renders the whole Cornell frame and a seeded
sample of the mesh frame's pixels.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from portbench.ref.dtypes import FLOAT_MAX
from portbench.ref.models import integrators as I
from portbench.ref.models.camera import generate_rays
from portbench.ref.models.materials import build_families
from portbench.ref.ops import film as F
from portbench.ref.ops import intersect as isect
from portbench.ref.ops.halton import (
    compute_pixel_offsets,
    halton_indices,
    halton_sample_2d,
    make_halton_config,
    make_permutations,
)
from portbench.ref.sceneio.compiler import compile_scene_file

PAIRS_PER_BLOCK = 1 << 26  # ray × primitive pairs of one dense block
RAYS_PER_CHUNK = 1 << 22  # camera rays traced together


def bf16_store(x):
    """The lower-precision control's ray state: held in bfloat16."""
    return x.to(torch.bfloat16).to(torch.float32)


def _dense(fn, n_prims: int, misses):
    """fn(o, d, t_max) over the live rays only, in blocks; `misses(o)` gives
    the full-size outputs a dead ray keeps. Geometry is detached, as the
    port's intersectors detach it."""
    step = max(PAIRS_PER_BLOCK // max(n_prims, 1), 1)

    def run(o, d, t_max):
        o, d, t_max = o.detach(), d.detach(), t_max.detach()
        out = misses(o)
        live = torch.nonzero(t_max > 0)[:, 0]
        for s in range(0, live.shape[0], step):
            idx = live[s:s + step]
            part = fn(o[idx], d[idx], t_max[idx])
            for full, p in zip(out, part if isinstance(part, tuple) else (part,)):
                full[idx] = p
        return out

    return run


def _intersectors(scene, device):
    def on(arrays):
        return type(arrays)(*(torch.as_tensor(np.ascontiguousarray(a), device=device)
                              for a in arrays))

    tris, sph = on(scene.tris), on(scene.spheres)
    n_prims = tris.count + sph.count

    def z(o, *tail, dtype=torch.float32, fill=0.0):
        return torch.full((o.shape[0],) + tail, fill, dtype=dtype, device=o.device)

    def hit_misses(o):
        return (z(o, fill=float(FLOAT_MAX)), z(o, dtype=torch.int32, fill=-1), z(o, 3), z(o, 3),
                z(o, 2), z(o, 3))

    closest = _dense(lambda o, d, t: tuple(isect.intersect_brute(o, d, t, tris, sph)), n_prims,
                     hit_misses)
    any_hit = _dense(lambda o, d, t: isect.intersect_predicate_brute(o, d, t, tris, sph), n_prims,
                     lambda o: (z(o, dtype=torch.bool, fill=False),))
    tprim = _dense(lambda o, d, t: isect.intersect_tprim_brute(o, d, t, tris, sph), n_prims,
                   lambda o: hit_misses(o)[:2])
    return (lambda o, d, t: isect.Hit(*closest(o, d, t)), lambda o, d, t: any_hit(o, d, t)[0],
            tprim)


def _context(scene, device) -> I.ShadeContext:
    inter, pred, tprim = _intersectors(scene, device)
    used_ids = set(np.asarray(scene.prim_mat).tolist()) - {-1}
    used = [mat for mat in scene.materials if mat.mat_id in used_ids]
    all_delta = I.mat_all_delta_table(scene.materials, scene.material_registry)
    return I.ShadeContext(
        materials=used,
        families=build_families(used, n_mats=all_delta.shape[0], device=device),
        registry=scene.material_registry,
        lights=scene.lights,
        dev_lights=scene.lights.on(device),
        envs=[env.on(device) for env in scene.envs],
        n_lights=scene.n_lights,
        mat_is_all_delta=torch.as_tensor(all_delta, device=device),
        intersect=inter,
        predicate=pred,
        intersect_tprim=tprim,
        prim_mat=torch.as_tensor(scene.prim_mat, device=device),
        prim_light=torch.as_tensor(scene.prim_light, device=device),
    )


def params_on(tree, device):
    """A params tree with numpy (or tensor) leaves → fresh tensors on device."""
    return {k: params_on(v, device) if isinstance(v, dict)
            else torch.as_tensor(np.array(v)).to(device) for k, v in tree.items()}


class Reference:
    """One scene at one seed: `render` gives pixel means and traced segments
    of any pixels, `train` follows the first steps of the inverse-rendering
    MSE step."""

    def __init__(self, scene_path: Path, overrides: dict, device):
        self.device = torch.device(device)
        self.scene = sc = compile_scene_file(scene_path, overrides)
        if sc.settings.integrator != "path" or sc.settings.filter != "box":
            raise ValueError("the reference renders the path integrator into the box film")
        xres, yres = sc.settings.resolution
        self.n_pixels = xres * yres
        self.cfg = make_halton_config((xres, yres), sc.settings.spp, seed=sc.settings.seed)
        self.perms = make_permutations(self.cfg.seed)
        offs = compute_pixel_offsets(self.cfg)[:yres, :xres].reshape(-1).astype(np.int64)
        ys, xs = np.mgrid[0:yres, 0:xres]
        xy = np.stack([xs.ravel(), ys.ravel()], axis=-1).astype(np.float32)
        self.pix_offsets = torch.as_tensor(offs, device=self.device)
        self.pix_xy = torch.as_tensor(xy, device=self.device)
        self.ctx = _context(sc, self.device)
        self.dim_base = 4 if sc.camera.has_lens else 2
        self.chunk = max(RAYS_PER_CHUNK // max(sc.settings.spp, 1), 1)

    def params(self):
        return params_on(self.scene.init_params, self.device)

    def _means(self, params, pixels, store=None):
        """(n, 3) box-film means of `pixels` ((n,) raster indices), traced
        segments (0-d int64): one chunk, differentiable in params."""
        sc, cfg = self.scene, self.cfg
        for fam in self.ctx.families:
            fam.stack_params(params)
        spp = sc.settings.spp
        C = pixels.shape[0]
        offs = self.pix_offsets[pixels][:, None].expand(C, spp).reshape(-1)
        sample_idx = torch.arange(spp, dtype=torch.int64, device=self.device).repeat(C)
        indices = halton_indices(offs, sample_idx, cfg)
        jitter = halton_sample_2d(indices, 0, cfg, self.perms) - 0.5
        film_xy = self.pix_xy[pixels][:, None].expand(C, spp, 2).reshape(-1, 2) + jitter
        lens_u = halton_sample_2d(indices, 2, cfg, self.perms) if sc.camera.has_lens else None
        o, d = generate_rays(sc.camera, film_xy, lens_u)
        radiance, segments = I.path_trace(self.ctx, params, o, d, indices, cfg, self.perms,
                                          sc.settings.max_depth, self.dim_base,
                                          count_rays=True, store=store)
        return F.accumulate_box(radiance, spp), segments

    def render(self, pixels=None, params=None, store=None):
        """→ ((n, 3) float32 means of `pixels` (every pixel when None), in
        their order, traced segments as an int), without a graph."""
        if pixels is None:
            pixels = torch.arange(self.n_pixels, device=self.device)
        params = self.params() if params is None else params
        out = torch.empty((pixels.shape[0], 3), dtype=torch.float32, device=self.device)
        segments = 0
        with torch.no_grad():
            for s in range(0, pixels.shape[0], self.chunk):
                means, seg = self._means(params, pixels[s:s + self.chunk], store)
                out[s:s + self.chunk] = means
                segments += int(seg)
        return out, segments

    def train(self, subtree: str, init: float, opt: dict, steps: int, store=None, pixels=None):
        """Follow `steps` inverse-rendering steps: every leaf under
        params[subtree] starts at `init`, the loss is the MSE of the box
        film over `pixels` (every pixel when None) against the render at the
        scene's own params, back-propagated a chunk at a time, and opt =
        {"name": "Adam", "lr": ..., ...} steps. → {"losses": [the loss
        before each step], "grads", "start", "end": per leaf (sorted keys),
        the first step's gradient, the leaf before the first and after the
        last step}."""
        target = self.render(store=store)[0]
        if pixels is None:
            pixels = torch.arange(self.n_pixels, device=self.device)
        params = self.params()
        node = params[subtree]
        xs = []
        for k in sorted(node):
            node[k] = torch.full_like(node[k], float(init)).requires_grad_(True)
            xs.append(node[k])
        start = [x.detach().clone() for x in xs]
        optimizer = make_optimizer(xs, opt)
        losses, grads = [], None
        for _ in range(steps):
            optimizer.zero_grad(set_to_none=True)
            total = torch.zeros((), dtype=torch.float32, device=self.device)
            for s in range(0, pixels.shape[0], self.chunk):
                sl = pixels[s:s + self.chunk]
                means, _ = self._means(params, sl, store)
                loss = torch.sum((means - target[sl]) ** 2) / (pixels.shape[0] * 3)
                loss.backward()
                total = total + loss.detach()
            if grads is None:
                grads = [x.grad.detach().clone() for x in xs]
            optimizer.step()
            losses.append(float(total))
        return {"losses": losses, "grads": grads, "start": start,
                "end": [x.detach().clone() for x in xs]}


def make_optimizer(leaves, opt: dict):
    """A torch.optim optimizer from a traffic file's {"name", "lr", ...}."""
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in opt.items() if k != "name"}
    return getattr(torch.optim, opt["name"])(leaves, **kw)
