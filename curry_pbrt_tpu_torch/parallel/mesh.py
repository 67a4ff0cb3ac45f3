"""Inverse rendering on one device: the train step (counterpart of the
JAX package's parallel/mesh.py make_sharded_train_step, without its mesh;
the cross-device gradient all-reduce is ROADMAP.md Queue 1 item 14).

A step renders the given pixels through render._render_chunk (box film),
takes the MSE against a target image, back-propagates it into the params
leaves that require grad, and steps a `torch.optim` optimizer over the
leaves the caller gave it (the counterpart of `optax.masked`).

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
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from curry_pbrt_tpu_torch.interop import params_from_numpy
from curry_pbrt_tpu_torch.render import RenderPlan, _render_chunk


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


def make_train_step(plan: RenderPlan, optimizer: torch.optim.Optimizer):
    """Inverse-rendering step over `optimizer`'s leaves → step(params,
    target, pix_offsets, pix_xy) → loss (detached 0-d tensor, the MSE
    before the update). target: (C,3) tensor on the plan's device;
    pix_offsets: (C,) int64 and pix_xy: (C,2) float32 on it, as
    render._render_chunk takes them; params: the scene's params tree, its
    optimized leaves tensors on the device that require grad. The step
    takes `times=` as backward_over_pixels does."""

    def step(params, target, pix_offsets, pix_xy, times: Optional[dict] = None):
        optimizer.zero_grad(set_to_none=True)
        params = params_from_numpy(params, plan.device)
        loss = backward_over_pixels(plan, params, pix_offsets, pix_xy, mse_pixel_loss(target),
                                    times)
        optimizer.step()
        return loss

    return step
