"""Render orchestration: scene → chunked wavefront rendering → film
(counterpart of the JAX package's render.py: path and direct-lighting
integrators, box and triangle films).

The film is split into pixel chunks; each chunk renders all its spp samples
in one batch of tensors on the render device, laid out pixel-major, and
reduces there: to per-pixel means (box film), or through the tent splat
into one full-film (film, weight) pair that every chunk adds into (triangle
film). The host enqueues work and reads back only the finished image (and
the NaN and segment counts).

On the card, render_plan runs its chunks through the plan's chunk program
(ChunkPrograms, the counterpart of the JAX package's one-dispatch
`_render_all` / `_render_all_splat`): each chunk shape's launches recorded
once as a CUDA graph and replayed for every later chunk and pass of the
plan; `graph=False` runs the eager loop, the A/B baseline. render_scene,
whose plan lives for one pass, runs the eager loop. The sharded render
(parallel/mesh.render_chunk_sharded) runs its slab's pieces through the
same runner (chunk_runner) and the same programs.
The CPU has no graphs and always runs the eager loop.

`_render_chunk` and `_render_chunk_splat` are differentiable with respect
to the params leaves that require grad (geometry stops at the traversal);
`render_scene` and `render_plan`, which return numpy, run without an
autograd graph.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from itertools import zip_longest
from typing import Callable, Optional

import numpy as np
import torch

from curry_pbrt_tpu_torch.interop import params_from_numpy
from curry_pbrt_tpu_torch.models import integrators as I
from curry_pbrt_tpu_torch.models.camera import generate_rays
from curry_pbrt_tpu_torch.models.materials import build_families, lobe_kinds
from curry_pbrt_tpu_torch.ops import bsdf as B
from curry_pbrt_tpu_torch.ops.bvh import build_flat_bvh, device_bvh
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
from curry_pbrt_tpu_torch.ops.kernels.aggregate import RAY_SORTS, make_kernel_intersectors
from curry_pbrt_tpu_torch.ops.kernels.bvh_kernel import make_bvh_intersectors
from curry_pbrt_tpu_torch.ops.kernels.intersect_kernel import LAUNCHES
from curry_pbrt_tpu_torch.sceneio.compiler import Scene, compile_scene_file
from curry_pbrt_tpu_torch.utils import trace
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


INTERSECTORS = ("kernel", "brute", "bvh")


def make_intersectors(scene: Scene, device, intersector: str = "kernel",
                      ray_sort: Optional[bool] = None):
    """The (intersect, predicate, intersect_tprim) seam: "kernel" — the
    traversal kernels over cluster tables (their plain versions on the
    CPU); "brute" — every ray against every primitive
    (ops/intersect.py's brute trio, dense (rays × primitives) tensors: for
    small scenes and as the oracle); "bvh" — the flat threaded BVH
    (ops/bvh.py, built by the native builder; the per-thread walk of
    csrc/bvh_walk.cu on the card, the plain lockstep loop on the CPU), the
    oracle at mesh scale."""
    if intersector == "kernel":
        cam_pos = np.asarray(scene.camera.camera_to_world)[:3, 3]
        return make_kernel_intersectors(scene.tris, scene.spheres, device, view_origin=cam_pos,
                                        ray_sort=ray_sort)
    if intersector not in INTERSECTORS:
        raise ValueError(f"unknown intersector {intersector!r} (one of {INTERSECTORS})")

    def on(arrays):
        return type(arrays)(*(torch.as_tensor(np.ascontiguousarray(a), device=device)
                              for a in arrays))

    tris, sph = on(scene.tris), on(scene.spheres)
    if intersector == "bvh":
        dbvh = device_bvh(build_flat_bvh(scene), scene.tris, scene.spheres, device)
        return make_bvh_intersectors(dbvh, tris, sph)

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
    families = build_families(used, n_mats=all_delta.shape[0], device=device)
    nee_fams = I.nondelta_families(families, scene.material_registry)
    return I.ShadeContext(
        materials=used,
        families=families,
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
        nee_slot=torch.as_tensor(I.family_slot_table(nee_fams, all_delta.shape[0]),
                                 device=device),
        nee_fams=nee_fams,
        nee_refusal=I.nee_plan_refusal(scene.lights, len(scene.envs), nee_fams,
                                       scene.material_registry),
        shade_slot=torch.as_tensor(I.family_slot_table(families, all_delta.shape[0]),
                                   device=device),
        shade_refusal=I.shade_plan_refusal(families, scene.material_registry),
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
    # the recorded chunk programs on the card (render_plan's and the sharded
    # render's: chunk_runner), made at first use
    programs: Optional["ChunkPrograms"] = field(default=None, repr=False)

    def max_delta_lobes(self) -> int:
        """The most delta lobes of any shaded material (0: direct lighting
        never recurses)."""
        return max((sum(1 for k in lobe_kinds(mat, self.scene.material_registry)
                        if k in B.DELTA_KINDS) for mat in self.ctx.materials), default=0)


def plan_render(scene: Scene, device="cuda", chunk_pixels: Optional[int] = None,
                ray_sort: Optional[bool] = None, intersector: str = "kernel") -> RenderPlan:
    """ray_sort: the aggregate's per-traversal ray sort (None: on beyond 512
    triangle clusters, as in the JAX package; True / False force it).
    intersector: "kernel" (the default on every device), "brute" or "bvh"
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
    spp = scene.settings.spp
    C = pix_offsets.shape[0]
    trace.stage("sample")
    # each pixel's value spp times (repeat_interleave by an expand: the
    # tensor-repeats form reads its output size back to the host)
    offs = pix_offsets[:, None].expand(C, spp).reshape(-1)
    sample_idx = torch.arange(spp, dtype=torch.int64, device=pix_offsets.device).repeat(C)
    indices = halton_indices(offs, sample_idx, cfg)
    jitter = halton_sample_2d(indices, 0, cfg, plan.perms) - 0.5
    lens_u = halton_sample_2d(indices, 2, cfg, plan.perms) if scene.camera.has_lens else None
    trace.stage("film")
    film_xy = pix_xy[:, None].expand(C, spp, 2).reshape(-1, 2) + jitter
    o, d = generate_rays(scene.camera, film_xy, lens_u)
    trace.stage("shade")
    for fam in plan.ctx.families:
        fam.stack_params(params)
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
    traced segments). Its device work is split into stages (utils/trace)."""
    with trace.stages(plan.device):
        radiance, _, segments = _chunk_sample_radiance(plan, params, pix_offsets, pix_xy)
        trace.stage("film")
        means, bad = F.accumulate_box(radiance, plan.scene.settings.spp, return_nan_counts=True)
    return means, bad, segments


def _chunk_taps(plan: RenderPlan, params, pix_offsets, pix_xy):
    """One chunk's tent-filter taps, before the splat: → (radiance (4M,3),
    pixel ids (4M,) int32, weights (4M,) — F.triangle_taps' —,
    dropped-NaN-sample count, traced segments), all of fixed shape. Its
    device work is split into stages (utils/trace)."""
    with trace.stages(plan.device):
        radiance, film_xy, segments = _chunk_sample_radiance(plan, params, pix_offsets, pix_xy)
        trace.stage("film")
        xres, yres = plan.scene.settings.resolution
        rad4, ids4, w4 = F.triangle_taps(film_xy, radiance, xres, yres)
        n_bad = torch.sum(torch.any(torch.isnan(radiance), dim=-1))
    return rad4, ids4, w4, n_bad, segments


def _render_chunk_splat(plan: RenderPlan, params, pix_offsets, pix_xy, n_pixels: int):
    """One chunk's FULL-FILM tent-splat contribution: → (film (n_pixels,3),
    wsum (n_pixels,), dropped-NaN-sample count, traced segments). A
    sample's footprint may cross chunk edges, so each chunk adds into a
    whole-film pair, which the caller sums over chunks."""
    rad4, ids4, w4, n_bad, segments = _chunk_taps(plan, params, pix_offsets, pix_xy)
    film, wsum = F.filter_splat(rad4, ids4, w4, n_pixels)
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


# ---------------------------------------------------------------------------
# the chunk program


def _record_cuda_graph(fn, device: torch.device, pool):
    """Record fn() as a CUDA graph, on a side stream and in the memory pool
    `pool` (torch.cuda.graph_pool_handle()): fn runs once as Python while
    the card records its launches, and computes nothing until the first
    replay. → (replay, fn's
    outputs, which every replay overwrites in place). A host sync in fn
    fails the recording, which raises ("thread_local": a sync of this
    thread fails it, a call of another thread, NCCL's watchdog say, does
    not); the side stream is left either way. The caching allocator's free
    blocks go back to the card first (as torch.cuda.graph does), so that
    the graph's pool does not sit beside the eager chunk's cached one."""
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    with torch.cuda.device(device), torch.cuda.stream(torch.cuda.Stream(device)):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            outs = fn()
        finally:
            graph.capture_end()
    return graph.replay, outs


def _recorder(device: torch.device):
    """ChunkPrograms' recording seam, record(fn) → (replay, outputs):
    _record_cuda_graph on a CUDA device, every recording of this recorder
    in one memory pool; None on the CPU, which has no graphs (its chunk
    loop is eager). The programs of a plan share its pool: they replay one
    at a time on one stream, and each replay's outputs are read before the
    next, so a working set the size of one chunk's serves them all."""
    if device.type != "cuda":
        return None
    return partial(_record_cuda_graph, device=device, pool=torch.cuda.graph_pool_handle())


# What a chunk counts on the host: kernel launches and sorted traversals.
_COUNTERS = (LAUNCHES, RAY_SORTS)


def _param_leaves(tree, path=()):
    """[(path, tensor)] of a params tree, keys in sorted order."""
    out = []
    for k in sorted(tree, key=str):
        v = tree[k]
        if isinstance(v, dict):
            out += _param_leaves(v, path + (str(k),))
        else:
            out.append((path + (str(k),), v))
    return out


def _layout(leaves):
    return [(path, tuple(t.shape), t.dtype, t.device) for path, t in leaves]


def _tree(leaves):
    """The params tree of [(path, tensor)] leaves."""
    tree = {}
    for path, t in leaves:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


@dataclass
class _Program:
    replay: Callable[[], None]
    pix_offsets: torch.Tensor  # static inputs: (C,) int64 and (C, 2) float32
    pix_xy: torch.Tensor
    outs: tuple  # static outputs, overwritten by every replay
    counts: list  # [(counter dict, key, count)] that a replay adds
    timelines: list  # the stage boundaries it captured (utils/trace)


class ChunkPrograms:
    """The plan's chunk program on the card: the counterpart of the JAX
    package's one-dispatch render, `_render_all`
    (curry_pbrt_tpu/render.py:294, a `lax.map` over the box film's chunks)
    and `_render_all_splat` (:320, a `lax.scan` carrying the tent film),
    which XLA compiles once and dispatches once.

    A chunk's launches are recorded once as a CUDA graph and replayed for
    every later chunk of the same shape, in this and every later call on
    the plan (render_plan's or the sharded render's): the same hand-written
    kernels and ops on the same inputs in the same order, so the image is
    the eager loop's bit for bit, and the host no longer issues each
    chunk's thousands of launches. One program per (film, chunk pixels): the full chunk, and the
    last chunk where chunk_pixels does not divide the film. The last chunk
    is not padded as the JAX package pads it: padded rays would add
    segments that the eager loop does not count.

    The plan's very first chunk runs eagerly, and its result is used: it
    loads the kernels' library, fills the occupancy queries the kernels
    cache on the host (csrc/bvh_walk.cu, csrc/slab_grid.cu) and whatever
    else is made at first use, none of which a recording may do. Its
    program is recorded right after it, in the same call, and any other
    chunk shape at its first need; every later chunk replays. So a plan's
    first pass (a warm-up) records all its programs, as the JAX package's
    first call compiles, and a one-chunk plan replays from its second
    pass on.

    A program holds static device buffers: its inputs (the chunk's pixel
    offsets and pixel xy, and one params tree that the plan's programs
    share) and its outputs. At the start of a call on a plan that has
    recorded, the call's params are copied into the recorded tree (one
    `torch._foreach_copy_`); a tree whose keys, shapes or dtypes differ
    raises — a program is never recorded again over other buffers. Each
    chunk's pixels are copied into the static inputs on the device, and
    the caller reads the outputs before the next replay.

    The launch counters count host calls: a recording counts a chunk's
    launches once without running them, and a replay makes no call. So the
    program takes the counters' change over the recording back out and adds
    it at every replay: a pass counts what the eager loop counts.

    The chunk's stage boundaries (utils/trace) are captured as event
    nodes, so every replay records them again. While a profiler session
    records, a replay is timed from an event before its input copies (the
    `launch` stage) and synchronised, and its stages are read into its
    span. Spans: `eager` (the first chunk), `record`, `replay`.

    `record(fn) → (replay, outputs)` is the recording seam (_recorder). A
    failure to record or replay raises; nothing falls back to the eager
    loop."""

    def __init__(self, record):
        self.record = record
        self.warm = False  # the plan's first chunk has run, eagerly
        self.programs = {}  # (film kind, chunk pixels) -> _Program
        self.params = None  # the recorded params tree, shared by the programs
        self.leaves = None  # its leaves, in _param_leaves order
        self._layout = None
        self.replays = 0

    def begin(self, params) -> None:
        """A call starts (chunk_runner): its params go into the recorded
        tree, where there is one."""
        if self.params is not None:
            self.load(params)

    def run(self, kind: str, fn, params, pix_offsets, pix_xy):
        """fn(params, pix_offsets, pix_xy) → one chunk's outputs: eagerly
        for the plan's first chunk, whose program is then recorded, else by
        a replay of the program of (kind, chunk pixels), recorded at first
        need. A replay's outputs are the program's static buffers: read
        them before the next chunk."""
        key = (kind, pix_offsets.shape[0])
        if not self.warm:
            self.warm = True
            with trace.span("eager"):
                outs = fn(params, pix_offsets, pix_xy)
            self._record(key, fn, params, pix_offsets, pix_xy)
            return outs
        prog = self.programs.get(key) or self._record(key, fn, params, pix_offsets, pix_xy)
        with trace.span("replay"):
            start = trace.device_mark(pix_offsets.device)
            prog.pix_offsets.copy_(pix_offsets)
            prog.pix_xy.copy_(pix_xy)
            prog.replay()
            if start is not None:
                torch.cuda.synchronize(pix_offsets.device)
                trace.replayed(start, prog.timelines)
        for counter, name, n in prog.counts:
            counter[name] += n
        self.replays += 1
        return prog.outs

    def load(self, params) -> None:
        """Copy params into the recorded tree; raises where its keys,
        shapes, dtypes or devices differ from the recorded tree's."""
        leaves = _param_leaves(params)
        layout = _layout(leaves)
        if layout != self._layout:
            diff = next((a, b) for a, b in zip_longest(layout, self._layout) if a != b)
            raise ValueError(f"the params tree differs from the one the chunk program was "
                             f"recorded with: {diff[0]} where it recorded {diff[1]}")
        torch._foreach_copy_(self.leaves, [t for _, t in leaves])

    def _record(self, key, fn, params, pix_offsets, pix_xy) -> _Program:
        with trace.span("record"):
            if self.params is None:
                leaves = [(path, t.detach().clone()) for path, t in _param_leaves(params)]
                self.params, self.leaves = _tree(leaves), [t for _, t in leaves]
                self._layout = _layout(leaves)
            static_po, static_xy = pix_offsets.clone(), pix_xy.clone()
            before = [dict(c) for c in _COUNTERS]
            counts = []
            try:
                with trace.recording() as timelines:
                    replay, outs = self.record(lambda: fn(self.params, static_po, static_xy))
                for counter, was in zip(_COUNTERS, before):
                    counts += [(counter, name, n - was.get(name, 0))
                               for name, n in counter.items() if n != was.get(name, 0)]
            finally:  # a recording launches nothing: the counters as they were
                for counter, was in zip(_COUNTERS, before):
                    counter.clear()
                    counter.update(was)
            prog = self.programs[key] = _Program(replay, static_po, static_xy, tuple(outs),
                                                 counts, timelines)
        return prog


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
    see plan_render. The plan is made for this one pass and dropped, so a
    recording could not pay for itself: the chunks run eagerly. Render a
    plan that is kept with render_plan to replay its chunk program."""
    plan = plan_render(scene, device, chunk_pixels, ray_sort, intersector)
    return render_plan(plan, params, show_progress=show_progress, count_rays=count_rays,
                       graph=False)


def render_plan(plan: RenderPlan, params=None, show_progress: bool = True,
                count_rays: bool = False, graph: bool = True):
    """render_scene over an existing plan (its tables, shading context and
    sampler set-up), so that several renders of one scene plan it once.

    The call moves the params tree to the device and uploads every pixel's
    offset and xy once, then renders the plan's chunks in order. On the
    card each chunk goes through the plan's ChunkPrograms (the first chunk
    of a fresh plan eagerly, every later one as a replay of its recorded
    CUDA graph); graph=False runs each chunk eagerly: the A/B baseline. The
    CPU has no graphs: its loop is always eager.

    The pass is the span `render_plan`, with `prepare` (the params and
    pixel arrays to the device), a `chunk` a chunk and `readback`
    (utils/trace)."""
    scene = plan.scene
    dev = plan.device
    xres, yres = scene.settings.resolution
    n_pixels = xres * yres
    tent = scene.settings.filter == "triangle"
    with trace.span("render_plan") as whole:
        with trace.span("prepare"):
            params = params_from_numpy(scene.init_params if params is None else params, dev)
            po, px = pixel_arrays(plan)
            run = chunk_runner(plan, params, po, px, graph)
        C = plan.chunk_pixels
        chunks = [slice(s, min(s + C, n_pixels)) for s in range(0, n_pixels, C)]
        film = _render_plan_splat if tent else _render_plan_box
        img, segments = film(plan, run, chunks, show_progress)
    log.info("rendered %dx%d @ %d spp%s on %s in %.2fs", xres, yres, scene.settings.spp,
             " (triangle filter)" if tent else "", dev, whole.seconds)
    img = img.reshape(yres, xres, 3)
    if count_rays:
        return img, int(segments.item())
    return img


def chunk_runner(plan: RenderPlan, params, pix_offsets, pix_xy, graph: bool = True):
    """The chunk loop's runner over one call's pixels → run(kind, fn, sl):
    fn(params, pix_offsets[sl], pix_xy[sl]), one chunk's outputs, through
    the plan's ChunkPrograms on the card (made at first use; `kind` names
    the film, and a program is recorded per kind and chunk pixels), or
    eagerly (span `eager`) with graph=False and on the CPU. A replay's
    outputs are the program's static buffers: read them before the next
    run. params: the call's tree on the plan's device, copied here into
    the recorded tree where there is one. render_plan's chunks and the
    sharded render's slab pieces (parallel/mesh.py) both run through it."""
    if graph and plan.programs is None:
        record = _recorder(plan.device)
        if record is not None:
            plan.programs = ChunkPrograms(record)
    programs = plan.programs if graph else None
    if programs is not None:
        programs.begin(params)

    def run(kind, fn, sl):
        if programs is None:
            with trace.span("eager"):
                return fn(params, pix_offsets[sl], pix_xy[sl])
        return programs.run(kind, fn, params, pix_offsets[sl], pix_xy[sl])

    return run


def _render_plan_box(plan: RenderPlan, run, chunks, show_progress: bool):
    """render_plan's box-filter branch: each chunk's pixel means into the
    image. → (image (P, 3) numpy, traced segments (0-d tensor))."""
    dev = plan.device
    xres = plan.scene.settings.resolution[0]
    n_pixels = chunks[-1].stop
    chunk_fn = partial(_render_chunk, plan)
    out = torch.empty((n_pixels, 3), dtype=torch.float32, device=dev)
    nan_counts = torch.zeros((n_pixels,), dtype=torch.int32, device=dev)
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    with torch.no_grad(), progress(len(chunks), enabled=show_progress) as tick:
        for sl in chunks:
            with trace.span("chunk"):
                means, bad, seg = run("box", chunk_fn, sl)
                out[sl] = means
                nan_counts[sl] = bad
                segments = segments + seg
            tick(1)
        with trace.span("readback"):
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
    return img, segments


def _render_plan_splat(plan: RenderPlan, run, chunks, show_progress: bool):
    """render_plan's triangle-filter branch: every chunk's taps (through
    render_plan's `run`, so recorded and replayed as its chunks are) are
    splat into one full-film (film, wsum) pair, in chunk order, then the
    film is normalized by its weights. The splat itself runs eagerly after
    each chunk (span `splat`): its sort reads the band of pixel ids back to
    the host. Only the real pixels of the last chunk are rendered, so no
    padding pixel ever reaches the splat. → (image (P, 3) numpy, traced
    segments (0-d tensor))."""
    dev = plan.device
    n_pixels = chunks[-1].stop
    taps_fn = partial(_chunk_taps, plan)
    film = torch.zeros((n_pixels, 3), dtype=torch.float32, device=dev)
    wsum = torch.zeros((n_pixels,), dtype=torch.float32, device=dev)
    nan_total = torch.zeros((), dtype=torch.int64, device=dev)
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    with torch.no_grad(), progress(len(chunks), enabled=show_progress) as tick:
        for sl in chunks:
            with trace.span("chunk"):
                rad4, ids4, w4, n_bad, seg = run("triangle", taps_fn, sl)
                with trace.span("splat"):
                    f, w = F.filter_splat(rad4, ids4, w4, n_pixels)
                    film = film + f
                    wsum = wsum + w
                nan_total = nan_total + n_bad
                segments = segments + seg
            tick(1)
        with trace.span("readback"):
            img = F.normalize_splat(film, wsum).cpu().numpy()
            nan_total = int(nan_total)
    if nan_total > 0:
        log.warning(
            "dropped %d NaN radiance sample(s) (filter-splat path) — "
            "the reference warns per sample (render.rs:34-40)", nan_total,
        )
    return img, segments


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
