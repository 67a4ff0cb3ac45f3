"""Render orchestration: scene → chunked wavefront rendering → film
(counterpart of the JAX package's render.py: path and direct-lighting
integrators, box and triangle films).

The film is split into pixel chunks; each chunk renders all its spp samples
in one batch of tensors on the render device, laid out pixel-major, and
reduces there: to per-pixel means (box film), or through the tent splat
into one full-film (film, weight) pair that every chunk adds into (triangle
film). The host enqueues work and reads back only the finished image (and
the NaN and segment counts).

`_render_chunk` and `_render_chunk_splat` are differentiable with respect
to the params leaves that require grad (geometry stops at the traversal);
`render_scene` and `render_plan`, which return numpy, run without a graph.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from curry_pbrt_tpu_torch.interop import params_from_numpy
from curry_pbrt_tpu_torch.models import integrators as I
from curry_pbrt_tpu_torch.models.camera import generate_rays
from curry_pbrt_tpu_torch.models.materials import build_families, lobe_kinds
from curry_pbrt_tpu_torch.ops import bsdf as B
from curry_pbrt_tpu_torch.ops import film as F
from curry_pbrt_tpu_torch.ops import intersect as isect
from curry_pbrt_tpu_torch.ops.halton import (
    HaltonConfig,
    compute_pixel_offsets,
    halton_indices,
    halton_sample_2d,
    make_halton_config,
    make_permutations,
)
from curry_pbrt_tpu_torch.ops.kernels.aggregate import make_kernel_intersectors
from curry_pbrt_tpu_torch.sceneio.compiler import Scene, compile_scene_file
from curry_pbrt_tpu_torch.utils.imageio import write_png
from curry_pbrt_tpu_torch.utils.logging import get_logger, progress

log = get_logger(__name__)

# Rays per chunk. Eager PyTorch launches every tensor op as its own kernel,
# so a chunk must be large enough that each launch has real work: 4M rays
# (the 512², 64 spp headline is 4 chunks) on the card. The CPU default stays
# small for memory. See PERF.md for the measurement behind the card value.
CHUNK_RAYS = {"cuda": 1 << 22, "cpu": 1 << 16}


def resolve_device(device) -> torch.device:
    """The render device. "cuda" requires a usable card: there is no
    fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported render device {device!r} (cuda or cpu)")
    return dev


INTERSECTORS = ("kernel", "brute")


def make_intersectors(scene: Scene, device, intersector: str = "kernel",
                      ray_sort: Optional[bool] = None):
    """The (intersect, predicate, intersect_tprim) seam: "kernel" — the
    traversal kernels over cluster tables (their plain versions on the
    CPU); "brute" — every ray against every primitive
    (ops/intersect.py's brute trio, dense (rays × primitives) tensors: for
    small scenes and as the oracle)."""
    if intersector == "kernel":
        cam_pos = np.asarray(scene.camera.camera_to_world)[:3, 3]
        return make_kernel_intersectors(scene.tris, scene.spheres, device, view_origin=cam_pos,
                                        ray_sort=ray_sort)
    if intersector == "bvh":
        raise NotImplementedError(
            "intersector 'bvh' is not ported to curry_pbrt_tpu_torch yet (ROADMAP.md Queue 1 "
            "item 13); use 'kernel' or 'brute'")
    if intersector != "brute":
        raise ValueError(f"unknown intersector {intersector!r} (one of {INTERSECTORS})")

    def on(arrays):
        return type(arrays)(*(torch.as_tensor(np.ascontiguousarray(a), device=device)
                              for a in arrays))

    tris, sph = on(scene.tris), on(scene.spheres)

    def detached(fn):
        return lambda o, d, t_max: fn(o.detach(), d.detach(), t_max.detach(), tris, sph)

    return (detached(isect.intersect_brute), detached(isect.intersect_predicate_brute),
            detached(isect.intersect_tprim_brute))


def make_shade_context(scene: Scene, device, ray_sort: Optional[bool] = None,
                       intersector: str = "kernel") -> I.ShadeContext:
    """Build the static shading context over the chosen intersector
    (make_intersectors)."""
    inter, pred, tprim = make_intersectors(scene, device, intersector, ray_sort)
    # only materials actually referenced by primitives participate in shading
    used_ids = set(np.asarray(scene.prim_mat).tolist()) - {-1}
    used = [mat for mat in scene.materials if mat.mat_id in used_ids]
    all_delta = I.mat_all_delta_table(scene.materials, scene.material_registry)
    return I.ShadeContext(
        materials=used,
        families=build_families(used, n_mats=all_delta.shape[0], device=device),
        registry=scene.material_registry,
        lights=scene.lights,
        dev_lights=scene.lights.on(device),
        envs=scene.envs,
        n_lights=scene.n_lights,
        mat_is_all_delta=torch.as_tensor(all_delta, device=device),
        intersect=inter,
        predicate=pred,
        intersect_tprim=tprim,
        prim_mat=torch.as_tensor(scene.prim_mat, device=device),
        prim_light=torch.as_tensor(scene.prim_light, device=device),
    )


@dataclass
class RenderPlan:
    scene: Scene
    ctx: I.ShadeContext
    cfg: HaltonConfig
    perms: np.ndarray
    pixel_offsets: np.ndarray  # (H, W) uint32
    chunk_pixels: int
    dim_base: int
    device: torch.device

    def max_delta_lobes(self) -> int:
        """The most delta lobes of any shaded material (0: direct lighting
        never recurses)."""
        return max((sum(1 for k in lobe_kinds(mat, self.scene.material_registry)
                        if k in B.DELTA_KINDS) for mat in self.ctx.materials), default=0)


def plan_render(scene: Scene, device="cuda", chunk_pixels: Optional[int] = None,
                ray_sort: Optional[bool] = None, intersector: str = "kernel") -> RenderPlan:
    """ray_sort: the aggregate's per-traversal ray sort (None: on beyond 512
    triangle clusters, as in the JAX package; True / False force it).
    intersector: "kernel" (the default on every device) or "brute"
    (make_intersectors)."""
    device = resolve_device(device)
    if scene.settings.integrator not in ("path", "directlighting"):
        raise ValueError(f"unknown integrator {scene.settings.integrator!r}")
    xres, yres = scene.settings.resolution
    spp = scene.settings.spp
    cfg = make_halton_config((xres, yres), spp, seed=scene.settings.seed)
    perms = make_permutations(cfg.seed)
    offs = compute_pixel_offsets(cfg)[:yres, :xres]
    if chunk_pixels is None:
        n_pixels = xres * yres
        chunk_pixels = max(min(CHUNK_RAYS[device.type] // max(spp, 1), n_pixels), 1)
    return RenderPlan(
        scene=scene,
        ctx=make_shade_context(scene, device, ray_sort, intersector),
        cfg=cfg,
        perms=perms,
        pixel_offsets=offs,
        chunk_pixels=chunk_pixels,
        dim_base=4 if scene.camera.has_lens else 2,
        device=device,
    )


def _chunk_sample_radiance(plan: RenderPlan, params, pix_offsets, pix_xy):
    """Per-SAMPLE radiance for one pixel chunk (shared by the box and splat
    films). params: a tree of tensors on the plan's device; pix_offsets:
    (C,) int64 Halton pixel offsets; pix_xy: (C,2) f32 integer pixel
    coords, both on the plan's device. Returns (radiance (C·spp,3), film_xy
    (C·spp,2), traced segments).

    The material families' member constants are stacked from `params` here,
    once per chunk, so that under grad every chunk's graph holds its own
    stacking and a backward per chunk frees only that chunk's graph."""
    scene, cfg = plan.scene, plan.cfg
    for fam in plan.ctx.families:
        fam.stack_params(params)
    spp = scene.settings.spp
    C = pix_offsets.shape[0]
    offs = torch.repeat_interleave(pix_offsets, spp)
    sample_idx = torch.arange(spp, dtype=torch.int64, device=pix_offsets.device).repeat(C)
    indices = halton_indices(offs, sample_idx, cfg)

    jitter = halton_sample_2d(indices, 0, cfg, plan.perms) - 0.5
    film_xy = torch.repeat_interleave(pix_xy, spp, dim=0) + jitter
    lens_u = halton_sample_2d(indices, 2, cfg, plan.perms) if scene.camera.has_lens else None
    o, d = generate_rays(scene.camera, film_xy, lens_u)
    if scene.settings.integrator == "path":
        radiance, segments = I.path_trace(
            plan.ctx, params, o, d, indices, cfg, plan.perms,
            scene.settings.max_depth, plan.dim_base, count_rays=True,
        )
    else:
        radiance, segments = I.direct_light_trace(
            plan.ctx, params, o, d, indices, cfg, plan.perms,
            scene.settings.max_depth, plan.dim_base, plan.max_delta_lobes(), count_rays=True,
        )
    return radiance, film_xy, segments


def _render_chunk(plan: RenderPlan, params, pix_offsets, pix_xy):
    """→ ((C, 3) box-filtered pixel means, (C,) dropped-NaN-sample counts,
    traced segments)."""
    radiance, _, segments = _chunk_sample_radiance(plan, params, pix_offsets, pix_xy)
    means, bad = F.accumulate_box(radiance, plan.scene.settings.spp, return_nan_counts=True)
    return means, bad, segments


def _render_chunk_splat(plan: RenderPlan, params, pix_offsets, pix_xy, n_pixels: int):
    """One chunk's FULL-FILM tent-splat contribution: → (film (n_pixels,3),
    wsum (n_pixels,), dropped-NaN-sample count, traced segments). A
    sample's footprint may cross chunk edges, so each chunk adds into a
    whole-film pair, which the caller sums over chunks."""
    radiance, film_xy, segments = _chunk_sample_radiance(plan, params, pix_offsets, pix_xy)
    xres, yres = plan.scene.settings.resolution
    rad4, ids4, w4 = F.triangle_taps(film_xy, radiance, xres, yres)
    film, wsum = F.filter_splat(rad4, ids4, w4, n_pixels)
    n_bad = torch.sum(torch.any(torch.isnan(radiance), dim=-1))
    return film, wsum, n_bad, segments


def _chunked_pixel_arrays(plan: RenderPlan):
    """Host-side (K, C) pixel-offset and (K, C, 2) pixel-xy chunk arrays,
    padded to a whole number of chunks (render_scene renders only the real
    pixels of the last chunk)."""
    xres, yres = plan.scene.settings.resolution
    n_pixels = xres * yres
    C = plan.chunk_pixels
    K = (n_pixels + C - 1) // C
    ys, xs = np.mgrid[0:yres, 0:xres]
    pix_xy = np.stack([xs.ravel(), ys.ravel()], axis=-1).astype(np.float32)
    offs = plan.pixel_offsets.reshape(-1)
    pad = K * C - n_pixels
    po = np.pad(offs, (0, pad)).reshape(K, C)
    px = np.pad(pix_xy, ((0, pad), (0, 0))).reshape(K, C, 2)
    return po, px, n_pixels


def pixel_arrays(plan: RenderPlan):
    """Every pixel's Halton offset ((P,) int64) and integer (x, y) ((P,2)
    float32), in raster order on the plan's device: the pixel arguments of
    _render_chunk, _render_chunk_splat and the train step for the whole
    film."""
    po, px, n_pixels = _chunked_pixel_arrays(plan)
    return (torch.as_tensor(po.reshape(-1)[:n_pixels].astype(np.int64), device=plan.device),
            torch.as_tensor(px.reshape(-1, 2)[:n_pixels], device=plan.device))


def render_scene(
    scene: Scene,
    params=None,
    device="cuda",
    chunk_pixels: Optional[int] = None,
    show_progress: bool = True,
    count_rays: bool = False,
    ray_sort: Optional[bool] = None,
    intersector: str = "kernel",
):
    """Full render → (H, W, 3) float32 numpy radiance image; with
    count_rays=True → (image, traced segments as a Python int).

    params: the scene's params tree (scene.init_params when None), with
    tensor or numpy leaves; it is moved to `device`. ray_sort, intersector:
    see plan_render."""
    plan = plan_render(scene, device, chunk_pixels, ray_sort, intersector)
    return render_plan(plan, params, show_progress=show_progress, count_rays=count_rays)


def render_plan(plan: RenderPlan, params=None, show_progress: bool = True,
                count_rays: bool = False):
    """render_scene over an existing plan (its tables, shading context and
    sampler set-up), so that several renders of one scene plan it once."""
    scene = plan.scene
    dev = plan.device
    params = params_from_numpy(scene.init_params if params is None else params, dev)
    xres, yres = scene.settings.resolution
    po, px, n_pixels = _chunked_pixel_arrays(plan)
    if scene.settings.filter == "triangle":
        return _render_plan_splat(plan, params, po, px, n_pixels, show_progress, count_rays)
    C = plan.chunk_pixels
    out = torch.empty((n_pixels, 3), dtype=torch.float32, device=dev)
    nan_counts = torch.zeros((n_pixels,), dtype=torch.int32, device=dev)
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.time()
    with torch.no_grad(), progress(po.shape[0], enabled=show_progress) as tick:
        for k in range(po.shape[0]):
            n_real = min(C, n_pixels - k * C)
            pk = torch.as_tensor(po[k, :n_real].astype(np.int64), device=dev)
            xk = torch.as_tensor(px[k, :n_real], device=dev)
            means, bad, seg = _render_chunk(plan, params, pk, xk)
            out[k * C:k * C + n_real] = means
            nan_counts[k * C:k * C + n_real] = bad
            segments = segments + seg
            tick(1)
        img = out.cpu().numpy()
        nan_np = nan_counts.cpu().numpy()
    nan_total = int(nan_np.sum())
    if nan_total > 0:
        worst = int(np.argmax(nan_np))
        log.warning(
            "dropped %d NaN radiance sample(s) (e.g. pixel %d, %d) — "
            "the reference warns per sample (render.rs:34-40)",
            nan_total, worst % xres, worst // xres,
        )
    log.info("rendered %dx%d @ %d spp on %s in %.2fs", xres, yres, scene.settings.spp,
             dev, time.time() - t0)
    img = img.reshape(yres, xres, 3)
    if count_rays:
        return img, int(segments.item())
    return img


def _render_plan_splat(plan: RenderPlan, params, po, px, n_pixels: int, show_progress: bool,
                       count_rays: bool):
    """render_plan's triangle-filter branch: every chunk adds its full-film
    (film, wsum) into one pair, in chunk order, then the film is normalized
    by its weights. Only the real pixels of the last chunk are rendered, so
    no padding pixel ever reaches the splat."""
    scene, dev, C = plan.scene, plan.device, plan.chunk_pixels
    xres, yres = scene.settings.resolution
    film = torch.zeros((n_pixels, 3), dtype=torch.float32, device=dev)
    wsum = torch.zeros((n_pixels,), dtype=torch.float32, device=dev)
    nan_total = torch.zeros((), dtype=torch.int64, device=dev)
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.time()
    with torch.no_grad(), progress(po.shape[0], enabled=show_progress) as tick:
        for k in range(po.shape[0]):
            n_real = min(C, n_pixels - k * C)
            pk = torch.as_tensor(po[k, :n_real].astype(np.int64), device=dev)
            xk = torch.as_tensor(px[k, :n_real], device=dev)
            f, w, n_bad, seg = _render_chunk_splat(plan, params, pk, xk, n_pixels)
            film = film + f
            wsum = wsum + w
            nan_total = nan_total + n_bad
            segments = segments + seg
            tick(1)
        img = F.normalize_splat(film, wsum).cpu().numpy()
    if int(nan_total) > 0:
        log.warning(
            "dropped %d NaN radiance sample(s) (filter-splat path) — "
            "the reference warns per sample (render.rs:34-40)", int(nan_total),
        )
    log.info("rendered %dx%d @ %d spp (triangle filter) on %s in %.2fs", xres, yres,
             scene.settings.spp, dev, time.time() - t0)
    img = img.reshape(yres, xres, 3)
    if count_rays:
        return img, int(segments.item())
    return img


def render_from_file(path, output: Optional[str] = None, overrides=None,
                     device="cuda", **kw) -> str:
    """Full pipeline (render.rs:63-82): parse → compile → render → PNG."""
    scene = compile_scene_file(path, overrides)
    image = render_scene(scene, device=device, **kw)
    out_path = output or scene.settings.filename
    u8 = F.to_srgb_u8(torch.from_numpy(image)).numpy()
    write_png(out_path, u8)
    print(out_path)
    return out_path
