"""Traffic kind "render": whole passes of the port's render entry,
`render.render_plan(plan, count_rays=True)`, back to back on one plan.

Set-up compiles the scene and plans it (plan_s), then renders one pass,
which records the plan's chunk programs: every pass of the window replays
them. A pass moves the scene's params to the card, renders every chunk,
and reads the image and the traced segments back, which ends it in a
synchronise.

The check: every pass of the window gave the last pass's image and
segments bit for bit, and the last pass agrees with the reference at the
check file's pixels ("all", or a sample of that many drawn from the seed).
"""

from __future__ import annotations

import gc
import hashlib
import time

import numpy as np
import torch

from portbench.trace import Sessions, csrc_kernels


def setup(cell, seed, dev, rec):
    from curry_pbrt_tpu_torch.render import plan_render, render_plan
    from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file

    t0 = time.perf_counter()
    scene = compile_scene_file(cell.scene_path, cell.overrides(seed))
    plan = plan_render(scene, device=dev, intersector=cell.config["intersector"])
    rec["plan_s"] = time.perf_counter() - t0
    state = {"plan": plan, "render": render_plan, "passes": []}
    unit(state)  # the warm-up: records the chunk programs
    state["passes"].clear()
    return state


def unit(state) -> bool:
    """One pass; keeps its image and a digest of it with its segments."""
    img, segments = state["render"](state["plan"], show_progress=False, count_rays=True)
    state["last"] = (img, segments)
    state["passes"].append((hashlib.blake2b(img.tobytes(), digest_size=16).digest(), segments))
    return True


def work(state, units: int) -> dict:
    xres, yres = state["plan"].scene.settings.resolution
    per_pass = xres * yres * state["plan"].scene.settings.spp
    return {"samples": units * per_pass, "samples_per_pass": per_pass,
            "segments_per_pass": state["last"][1]}


def trace(state, rec):
    """One more pass, each chunk program's run in a profiler session of its
    own, then one eager pass (graph=False: the replay's calls) that notes
    each traversal launch's rays, live rays and bytes."""
    from curry_pbrt_tpu_torch import render as R
    from curry_pbrt_tpu_torch.ops.kernels import intersect_kernel as K

    plan = state["plan"]
    sessions = Sessions(plan.device)
    real_run = R.ChunkPrograms.run

    def run(self, *a, **kw):
        with sessions.unit():
            out = real_run(self, *a, **kw)
        return out

    R.ChunkPrograms.run = run
    try:
        state["render"](plan, show_progress=False, count_rays=True)
    finally:
        R.ChunkPrograms.run = real_run

    calls = []
    real_launch = K.launch_entry

    def launch_entry(lib, entry, outs, o, d, t_max, prims, caabb, saabb, slab_aabb, *rest):
        if o.shape[0]:
            calls.append({
                "entry": entry, "rays": o.shape[0], "live": int((t_max > 0).sum()),
                "out_bytes": sum(x.numel() * x.element_size() for x in outs if x is not None),
                "table_bytes": sum(x.numel() * x.element_size()
                                   for x in (prims, caabb, saabb, slab_aabb)),
            })
        return real_launch(lib, entry, outs, o, d, t_max, prims, caabb, saabb, slab_aabb, *rest)

    K.launch_entry = launch_entry
    try:
        state["render"](plan, show_progress=False, count_rays=True, graph=False)
    finally:
        K.launch_entry = real_launch
    summary, ops = sessions.summary()
    rec["trace"] = dict(summary, passes=1, calls=calls, csrc=csrc_kernels(rec["package_dir"]))
    return {"device_ops": ops, "idle_gaps": []}


# ---------------------------------------------------------------------------
# the check


def sample_pixels(check: dict, n_pixels: int, seed: int) -> np.ndarray:
    """The raster indices the check compares: every pixel, or a sorted
    sample drawn from the seed."""
    if check["pixels"] == "all" or int(check["pixels"]) >= n_pixels:
        return np.arange(n_pixels)
    return np.sort(np.random.default_rng(seed).choice(n_pixels, int(check["pixels"]),
                                                      replace=False))


def answers(state) -> dict:
    """The program's answers: the last pass's image (raster order) and
    segments, and every pass's (digest, segments)."""
    img, segments = state["last"]
    return {"image": img.reshape(-1, 3), "segments": segments, "passes": list(state["passes"])}


def reference(cell, seed, device, store=None) -> dict:
    """The reference's image at the check's pixels, and its segments."""
    from portbench.ref.render import Reference

    ref = Reference(cell.scene_path, cell.overrides(seed), device)
    pixels = sample_pixels(cell.check, ref.n_pixels, seed)
    img, segments = ref.render(torch.as_tensor(pixels, device=ref.device), store=store)
    return {"pixels": pixels, "image": img.cpu().numpy(), "segments": segments,
            "n_pixels": ref.n_pixels}


def control(cell, seed, device, store) -> dict:
    """The reference with its ray state passed through `store`, in the
    program's place: answers as `answers` gives them, at the check's
    pixels."""
    r = reference(cell, seed, device, store)
    img = np.zeros((r["n_pixels"], 3), np.float32)
    img[r["pixels"]] = r["image"]
    return {"image": img, "segments": r["segments"], "passes": [b""]}


def faults(cell, seed, device) -> dict:
    """Faults read at the cell's size on the card: none for a render (the
    control sets its upper readings)."""
    return {}


def compare(prog: dict, ref: dict, check: dict) -> dict:
    """{name: (value, limit)}. passes_differing: passes whose image or
    segments differ from the last pass's (exact). px_off_share: the share of
    the compared pixels whose largest channel gap exceeds px_rel of the
    reference's largest channel (+ floor). sum_gap: the relative gap of the
    compared pixels' sums. segments_gap, where the check has its limit (and
    compares every pixel): the relative gap of the traced segments."""
    limits = check["limits"]
    p = prog["image"][ref["pixels"]].astype(np.float64)
    r = ref["image"].astype(np.float64)
    gap = np.abs(p - r).max(axis=-1) / (np.abs(r).max(axis=-1) + check["floor"])
    last = prog["passes"][-1]
    numbers = {
        "passes_differing": (float(sum(h != last for h in prog["passes"])), 0.0),
        "px_off_share": (float(np.mean(gap > check["px_rel"])), limits["px_off_share"]),
        "sum_gap": (float(abs(p.sum() - r.sum()) / abs(r.sum())), limits["sum_gap"]),
    }
    if "segments_gap" in limits:
        if len(ref["pixels"]) != ref["n_pixels"]:
            raise ValueError("segments_gap compares the whole frame's segments: check every pixel")
        numbers["segments_gap"] = (abs(prog["segments"] - ref["segments"]) / ref["segments"],
                                   limits["segments_gap"])
    return numbers


def check(state, cell, seed) -> dict:
    """Frees the program's plan, then holds its answers against the
    reference's."""
    prog = answers(state)
    device = state["plan"].device
    state.clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return compare(prog, reference(cell, seed, device), cell.check)
