"""Inverse rendering and ray sharding (counterpart of the JAX package's
parallel/mesh.py): the train step on one device, and the sharded render and
train step over the ranks of a torch.distributed process group.

The train step renders the given pixels through render._render_chunk (box
film), takes the MSE against a target image, back-propagates it into the
params leaves that require grad, and steps a `torch.optim` optimizer over
the leaves the caller gave it (the counterpart of `optax.masked`).

The JAX step differentiates one chunk of pixels in one graph. At full
width (16.7M samples at 512², 64 spp) one graph does not fit, so the
pixels are split into sub-chunks of the plan's chunk_pixels — the render
chunk, 4M rays on the card — and each sub-chunk's share of the loss is
back-propagated on its own: the per-pixel MSE is a sum over pixels, so the
`.grad` the sub-chunks accumulate is the one-graph gradient, up to the
order of the float additions. A graph keeps ~0.5 KB a ray when only a
texture requires grad and ~2.8 KB when every leaf does (cornell_tex at
depth 5), so a 4M-ray graph holds 2–12 GB.

    plan = plan_render(scene, device="cuda")
    params = params_from_numpy(scene.init_params, "cuda")
    tex = params["textures"][key].requires_grad_(True)
    step = make_train_step(plan, torch.optim.Adam([tex], lr=0.05))
    loss = step(params, target, *render.pixel_arrays(plan))

Sharding (make_mesh, render_chunk_sharded, make_sharded_train_step): the
JAX package shards the pixel axis over a device mesh with `shard_map`; here
every rank is a process of the default torch.distributed group (NCCL on
cards, gloo on the CPU; parallel/multihost.initialize joins it). The scene,
its tables and the params are replicated on every rank; the pixels of a
chunk are split into contiguous slabs, one a rank, padded to a multiple of
the world size; the film rows are gathered, and the loss and gradients are
averaged over the ranks with an all-reduce (JAX's `pmean`). Each ray's
Halton stream depends only on (pixel, sample) and the box film's per-pixel
mean does not cross pixels, so the sharded image is the unsharded one: on
the card bit for bit; on the CPU within a few ULPs, since torch's
vectorised CPU kernels round a loop's scalar tail differently and the slab
lengths differ.

    dist = multihost.initialize("host0:8476", world, rank)   # or your launcher
    mesh = make_mesh(device="cuda")        # this rank's card becomes current
    plan = plan_render(scene, device=mesh.device)
    film = render_chunk_sharded(plan, mesh, scene.init_params, *pixel_arrays(plan))
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist

from curry_pbrt_tpu_torch.interop import params_from_numpy
from curry_pbrt_tpu_torch.render import RenderPlan, _render_chunk, resolve_device


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def backward_over_pixels(plan: RenderPlan, params, pix_offsets, pix_xy,
                         pixel_loss: Callable, times: Optional[dict] = None):
    """Σ over sub-chunks of pixel_loss(image rows (S,3), slice of the pixel
    arrays) — plan.chunk_pixels pixels each — each sub-chunk
    back-propagated on its own so that `.grad` accumulates on the params
    leaves that require grad. params: a tree of tensors on the plan's
    device. Returns the loss, a detached 0-d tensor.

    times: when a dict is given, the device is synchronized around every
    forward and backward and their seconds added under "forward_s" and
    "backward_s" (without it the host never waits on the device)."""
    C, S = pix_offsets.shape[0], plan.chunk_pixels
    total = torch.zeros((), dtype=torch.float32, device=plan.device)
    for s in range(0, C, S):
        sl = slice(s, min(s + S, C))
        if times is not None:
            _sync(plan.device)
            t0 = time.perf_counter()
        img, _, _ = _render_chunk(plan, params, pix_offsets[sl], pix_xy[sl])
        loss = pixel_loss(img, sl)
        if times is not None:
            _sync(plan.device)
            t1 = time.perf_counter()
            times["forward_s"] = times.get("forward_s", 0.0) + t1 - t0
        loss.backward()
        if times is not None:
            _sync(plan.device)
            times["backward_s"] = times.get("backward_s", 0.0) + time.perf_counter() - t1
        total = total + loss.detach()
    return total


def mse_pixel_loss(target):
    """The image MSE's share of one sub-chunk: Σ (img − target)² over its
    rows, over the whole target's value count."""
    return lambda img, sl: torch.sum((img - target[sl]) ** 2) / target.numel()


# ---------------------------------------------------------------------------
# sharding over the ranks of a process group


@dataclass(frozen=True)
class RayMesh:
    """The ranks that share the pixels: this process's rank of world_size,
    its device, and the process group (None outside an initialised group:
    world size 1, no collective)."""

    group: Optional[dist.ProcessGroup]
    rank: int
    world_size: int
    device: torch.device


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> RayMesh:
    """This process's place among the ranks of the initialised default
    group (n_devices, when given, must be its world size), or world size 1
    on `device` outside one. "cuda" without an index is card rank mod the
    card count: one rank a card, ranks beyond the count sharing the cards.
    The rank's card is made the current device, before any launch: the
    kernels launch on the current device (ops/kernels/build.py)."""
    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        group, rank, world = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    else:
        group, rank, world = None, 0, 1
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks asked for, but the process group has "
                         f"{world} (start one process per rank; parallel/multihost.py)")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return RayMesh(group, rank, world, dev)


def check_film(scene, world_size: int) -> None:
    """The sharded render is the box film's, whatever the scene's filter (as
    the JAX package's is). A tent-filter sample splats across pixel
    boundaries, into pixels of another rank's slab, which would need a
    summed film that the JAX package does not have either; at more than one
    rank, raise rather than render a different image. At one rank the box
    film is rendered (the tent film is render.render_scene's)."""
    if world_size > 1 and scene.settings.filter == "triangle":
        raise ValueError("the sharded render renders the box film; a scene with "
                         "Film \"filter\" \"triangle\" renders on one rank only")


def _slab(mesh: RayMesh, n: int):
    """(S, lo, hi): every rank's share S of n rows padded to a multiple of
    the world size, and this rank's real rows [lo, hi)."""
    S = -(-n // mesh.world_size)
    lo = min(mesh.rank * S, n)
    return S, lo, min(lo + S, n)


def _gather_rows(mesh: RayMesh, rows):
    """Every rank's (S, 3) rows → the (W·S, 3) film in rank order, on every
    rank. NCCL gathers into one tensor. Gloo's all_gather takes no CUDA
    tensor (two ranks sharing one card run over gloo: NCCL refuses them),
    so there every rank writes its rows into a zero film and the films are
    summed by an all-reduce, which takes one: exact (x + 0 = x; a -0.0
    becomes +0.0, equal in value), the same code for CPU and CUDA tensors,
    for W times the bytes of a gather — a film is megabytes."""
    if mesh.group is None:
        return rows
    W, S = mesh.world_size, rows.shape[0]
    if dist.get_backend(mesh.group) == "nccl":
        out = torch.empty((W * S,) + tuple(rows.shape[1:]), dtype=rows.dtype, device=rows.device)
        # all_gather_single is the newer name of all_gather_into_tensor
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(out, rows.contiguous(), group=mesh.group)
        return out
    film = torch.zeros((W * S,) + tuple(rows.shape[1:]), dtype=rows.dtype, device=rows.device)
    film[mesh.rank * S:(mesh.rank + 1) * S] = rows
    dist.all_reduce(film, op=dist.ReduceOp.SUM, group=mesh.group)
    return film


def render_chunk_sharded(plan: RenderPlan, mesh: RayMesh, params, pix_offsets, pix_xy):
    """Sharded render._render_chunk → the (C, 3) box-filtered film on every
    rank. pix_offsets (C,) int64 and pix_xy (C, 2) float32 are the whole
    chunk, the same on every rank; C is padded to a multiple of the world
    size (as the JAX multihost path pads), and this rank renders its rows
    [r·C/W, (r+1)·C/W) through _render_chunk in pieces of at most
    plan.chunk_pixels (the render chunk: a full-width slab would not fit
    one graph), without a graph. The padding rows are not rendered. The
    JAX function renders one chunk of all its pixels; the differentiable
    route here is make_sharded_train_step."""
    check_film(plan.scene, mesh.world_size)
    C = pix_offsets.shape[0]
    S, lo, hi = _slab(mesh, C)
    params = params_from_numpy(params, plan.device)
    rows = torch.zeros((S, 3), dtype=torch.float32, device=pix_offsets.device)
    with torch.no_grad():
        for s in range(lo, hi, plan.chunk_pixels):
            e = min(s + plan.chunk_pixels, hi)
            rows[s - lo:e - lo] = _render_chunk(plan, params, pix_offsets[s:e], pix_xy[s:e])[0]
        return _gather_rows(mesh, rows)[:C]


def make_sharded_render(plan: RenderPlan, mesh: RayMesh):
    """render_chunk_sharded over a fixed plan and mesh → render(params,
    pix_offsets, pix_xy) (no jit to port)."""
    return lambda params, pix_offsets, pix_xy: render_chunk_sharded(plan, mesh, params,
                                                                    pix_offsets, pix_xy)


def make_sharded_train_step(plan: RenderPlan, mesh: RayMesh,
                            optimizer: torch.optim.Optimizer):
    """Inverse-rendering step over the mesh's ranks → step(params, target,
    pix_offsets, pix_xy, times=None) → loss (detached 0-d tensor, the MSE
    before the update), with the arguments make_train_step's step takes:
    the whole chunk on every rank (C divisible by the world size: a padding
    pixel would change the loss). Each rank back-propagates
    the MSE over its own slab of C/W pixels (backward_over_pixels, the
    per-device mean of JAX's device_grads); then the loss and the `.grad` of
    every leaf of the optimizer are averaged over the ranks by an all-reduce
    (JAX's pmean: a sum, over the world size), and every rank takes the same
    optimizer step. A leaf whose slab left its grad None gets a zero grad,
    so every rank reduces the same tensors. With `times`, the all-reduce's
    seconds are added under "allreduce_s" too."""

    def step(params, target, pix_offsets, pix_xy, times: Optional[dict] = None):
        C = pix_offsets.shape[0]
        if C % mesh.world_size:
            raise ValueError(f"the sharded step splits {C} pixels over {mesh.world_size} ranks: "
                             f"give it a multiple of the world size")
        S = C // mesh.world_size
        sl = slice(mesh.rank * S, (mesh.rank + 1) * S)
        optimizer.zero_grad(set_to_none=True)
        params = params_from_numpy(params, plan.device)
        loss = backward_over_pixels(plan, params, pix_offsets[sl], pix_xy[sl],
                                    mse_pixel_loss(target[sl]), times)
        if mesh.group is not None:
            if times is not None:
                _sync(plan.device)
                t0 = time.perf_counter()
            for group in optimizer.param_groups:
                for leaf in group["params"]:
                    if leaf.grad is None:
                        leaf.grad = torch.zeros_like(leaf)
                    dist.all_reduce(leaf.grad, op=dist.ReduceOp.SUM, group=mesh.group)
                    leaf.grad.div_(mesh.world_size)
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=mesh.group)
            loss = loss / mesh.world_size
            if times is not None:
                _sync(plan.device)
                times["allreduce_s"] = times.get("allreduce_s", 0.0) + time.perf_counter() - t0
        optimizer.step()
        return loss

    return step


def make_train_step(plan: RenderPlan, optimizer: torch.optim.Optimizer):
    """Inverse-rendering step over `optimizer`'s leaves on the plan's device
    alone → step(params, target, pix_offsets, pix_xy) → loss (detached 0-d
    tensor, the MSE before the update). target: (C,3) tensor on the plan's
    device; pix_offsets: (C,) int64 and pix_xy: (C,2) float32 on it, as
    render._render_chunk takes them; params: the scene's params tree, its
    optimized leaves tensors on the device that require grad. The step
    takes `times=` as backward_over_pixels does. It is the sharded step
    over a one-rank mesh outside any group: no collective, whatever group
    the process has joined."""
    return make_sharded_train_step(plan, RayMesh(None, 0, 1, plan.device), optimizer)
