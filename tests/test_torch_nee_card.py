"""Next-event estimation's kernels on the card (csrc/nee.cu through
ops/kernels/nee.py) against the plain path, uniform_sample_one_light's
PyTorch body. Imports nothing of JAX, so that it runs where only the port
is installed:

    python -m pytest --noconftest tests/test_torch_nee_card.py -q -s

  - cornell_tex and mesh10k (the benchmark's two scenes) at 96², 16 spp,
    their own depth: every bounce of a real path (the hits, lobes, masks and
    sampler values path_trace hands to uniform_sample_one_light), the
    kernels' radiance and their shadow and MIS rays against the plain
    path's on the lanes whose result is consumed; every other lane's rays
    have t_max 0;
  - each call advances LAUNCHES["nee_sample"] and ["nee_finish"] by one
    and counts `nee_kernel` on the open span;
  - a render through the chunk program (record, then replay) equal to the
    eager render, both through the kernels; with autograd on, the plain
    path and no launch;
  - the headline shape: a 4,194,304-lane bounce of each cell's middle chunk,
    the two kernels' device ms (torch.profiler) beside the walks' and the
    other ops' of the call (the walks' wrappers: the dense sphere test on
    Cornell, the hit merges), the whole call's ms against the plain path's
    (CUDA events, in turns), and the kernels' bytes bound at 3.35 TB/s,
    printed as one JSON line a bounce.

Tolerance: the kernels keep the plain path's order of operations, and are
built like every csrc kernel (-fmad=false, IEEE division and square root),
so a lane's radiance and rays are bit-equal to it but where a libdevice
transcendental (cosf / sinf in the cosine and GGX samples) or rsqrtf
rounds otherwise than PyTorch's elementwise kernel of the same function:
at most MAX_DIFF_SHARE of the consumed lanes may differ, each by at most
MAX_REL of its value (or MAX_ABS where the value is near 0). Without a card
each test skips (marked cuda).
"""

import json
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

from curry_pbrt_tpu_torch import render
from curry_pbrt_tpu_torch.interop import params_from_numpy
from curry_pbrt_tpu_torch.models import integrators as I
from curry_pbrt_tpu_torch.ops.kernels import nee as NK
from curry_pbrt_tpu_torch.ops.kernels.intersect_kernel import LAUNCHES
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file
from curry_pbrt_tpu_torch.utils import trace

REPO = Path(__file__).resolve().parents[1]
SCENES = {"cornell_tex": ("portbench/scenes/cornell_tex.pbrt", 5),
          "mesh10k": ("portbench/scenes/mesh10k.pbrt", 8)}
MAX_DIFF_SHARE = 1e-3
MAX_REL = 1e-5
MAX_ABS = 1e-6
HBM = 3.35e12  # bytes/s, H100 SXM

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/nee.cu has no CPU mode")
    return torch.device("cuda")


def _plan(name, res, spp, chunk_pixels=None):
    path, depth = SCENES[name]
    scene = compile_scene_file(REPO / path, {"resolution": (res, res), "spp": spp,
                                             "max_depth": depth})
    plan = render.plan_render(scene, device="cuda", chunk_pixels=chunk_pixels)
    return plan, params_from_numpy(scene.init_params, "cuda")


def _calls(plan, params, pixels, start=0):
    """The arguments of every uniform_sample_one_light call of the plan's
    chunk over `pixels` pixels from `start`, one a bounce, by name, its
    shading frame given (chip_smoke.py's path_calls)."""
    smoke = runpy.run_path(str(REPO / "chip_smoke.py"), run_name="chip_smoke")
    return smoke["path_calls"](plan, params, start, pixels, "uniform_sample_one_light")


def _walked(ctx, fn):
    """fn() with ctx's two walks wrapped to keep the rays they were given:
    → (fn's result, {"vis": (o, d, t_max), "mis": (o, d, t_max)})."""
    rays = {}
    pred, tprim = ctx.predicate, ctx.intersect_tprim

    def vis(o, d, t):
        rays["vis"] = (o.clone(), d.clone(), t.clone())
        return pred(o, d, t)

    def mis(o, d, t):
        rays["mis"] = (o.clone(), d.clone(), t.clone())
        return tprim(o, d, t)

    ctx.predicate, ctx.intersect_tprim = vis, mis
    try:
        return fn(), rays
    finally:
        ctx.predicate, ctx.intersect_tprim = pred, tprim


def _differ(a, b):
    """(share of rows that differ in any bit, largest relative difference
    of those rows: |a − b| / max(|b|, MAX_ABS / MAX_REL))."""
    if a.shape[0] == 0:
        return 0.0, 0.0
    rows = (a.view(torch.int32) != b.view(torch.int32)).reshape(a.shape[0], -1).any(-1)
    if not rows.any():
        return 0.0, 0.0
    floor = MAX_ABS / MAX_REL
    rel = ((a[rows] - b[rows]).abs() / b[rows].abs().clamp(min=floor)).max()
    return float(rows.float().mean()), float(rel)


def _compare(c):
    ctx, mask = c["ctx"], c["mask"]
    with torch.no_grad():
        got, krays = _walked(ctx, lambda: NK.nee(**c))
        want, prays = _walked(ctx, lambda: I.uniform_sample_one_light_plain(**c))
    stats = {"lanes": int(mask.shape[0]), "consumed": int(mask.sum())}
    stats["radiance"] = _differ(got[mask], want[mask])
    for key in ("vis", "mis"):
        (ko, kd, kt), (po, pd, pt) = krays[key], prays[key]
        assert torch.equal(kt, pt), key  # t_max: the plain path's where(mask, ., 0)
        assert bool((kt[~mask] == 0).all())
        stats[key + "_o"] = _differ(ko[mask], po[mask])
        stats[key + "_d"] = _differ(kd[mask], pd[mask])
    return stats


@pytest.mark.parametrize("name", sorted(SCENES))
def test_kernels_match_the_plain_path_at_every_bounce(card, name):
    plan, params = _plan(name, 96, 16)
    with torch.no_grad():
        assert I.nee_refusal(plan.ctx, card) is None
    calls = _calls(plan, params, 96 * 96)
    assert len(calls) == SCENES[name][1]
    for bounce, c in enumerate(calls):
        stats = _compare(c)
        print(json.dumps({"scene": name, "bounce": bounce, **stats}))
        for key, (share, rel) in ((k, v) for k, v in stats.items() if isinstance(v, tuple)):
            assert share <= MAX_DIFF_SHARE and rel <= MAX_REL, (key, share, rel)


def test_each_call_launches_both_kernels_once(card):
    plan, params = _plan("mesh10k", 32, 4)
    c, *_ = _calls(plan, params, 32 * 32)
    before = dict(LAUNCHES)
    with torch.no_grad(), trace.span("nee_probe") as node:
        I.uniform_sample_one_light(**c)
        I.uniform_sample_one_light(**c)
    assert LAUNCHES["nee_sample"] - before["nee_sample"] == 2
    assert LAUNCHES["nee_finish"] - before["nee_finish"] == 2
    assert node.counts == {"nee_kernel": 2}
    with torch.enable_grad(), trace.span("nee_probe") as node:
        I.uniform_sample_one_light(**c)  # autograd on: the plain path
    assert LAUNCHES["nee_sample"] - before["nee_sample"] == 2
    assert node.counts == {"nee_plain": 1}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_replayed_render_equals_the_eager_render(card, name):
    plan, params = _plan(name, 64, 8, chunk_pixels=1000)
    eager = render.render_plan(plan, params, show_progress=False, graph=False)
    trace.reset()
    before = dict(LAUNCHES)
    recorded = render.render_plan(plan, params, show_progress=False)  # records, then replays
    replayed = render.render_plan(plan, params, show_progress=False)  # replays only
    for img in (recorded, replayed):
        assert np.array_equal(img.view(np.uint32), eager.view(np.uint32))
    counts = trace.count_totals()
    assert counts.get(("record", "nee_kernel"), 0) > 0
    assert not any(counter == "nee_plain" for _, counter in counts)
    calls = (LAUNCHES["nee_sample"] - before["nee_sample"]) // 2
    assert calls == 5 * SCENES[name][1]  # ceil(4096 / 1000) chunks a pass, a call a bounce
    assert LAUNCHES["nee_finish"] - before["nee_finish"] == 2 * calls


def _timed(fn, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


@pytest.mark.parametrize("name", sorted(SCENES))
def test_headline_bounce_times(card, name):
    """At the cell's chunk (4,194,304 lanes): every bounce of the chunk
    that holds the frame's middle row (the first chunk of the mesh frame is
    sky), timed. Prints one JSON line a bounce; asserts agreement only."""
    res, spp = {"cornell_tex": (512, 64), "mesh10k": (1024, 32)}[name]
    plan, params = _plan(name, res, spp)
    C = plan.chunk_pixels
    calls = _calls(plan, params, C, start=(res * res // 2) // C * C)
    dev_name = torch.cuda.get_device_name(0)
    for bounce, c in enumerate(calls):
        stats = _compare(c)
        with torch.no_grad():
            times = {"kernel_ms": [], "plain_ms": []}
            for _ in range(2):  # in turns: plain, kernel, kernel, plain
                times["plain_ms"].append(_timed(lambda: I.uniform_sample_one_light_plain(**c), 3))
                times["kernel_ms"].append(_timed(lambda: NK.nee(**c), 3))
                times["kernel_ms"].append(_timed(lambda: NK.nee(**c), 3))
                times["plain_ms"].append(_timed(lambda: I.uniform_sample_one_light_plain(**c), 3))
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                NK.nee(**c)
                torch.cuda.synchronize()
            dev_us = {}  # the two kernels, the walks (the other csrc kernels), the rest
            for ev in prof.key_averages():
                k = next((k for k in ("nee_sample_kernel", "nee_finish_kernel", "curry::")
                          if k in ev.key), "other")
                dev_us[k] = dev_us.get(k, 0.0) + ev.device_time_total
            flags = NK.nee_sample(c["ctx"], c["params"]["light_L"], c["hit"], c["mat_ids"],
                                  c["wo"], c["u"], c["fam_lobes"], c["mask"], NK._library(),
                                  torch.cuda.current_stream().cuda_stream).flags
        bound = sum(NK.bound_bytes(c["mat_ids"], c["fam_lobes"], c["mask"], flags))
        line = {"scene": name, "bounce": bounce, "device": dev_name, **stats,
                "kernel_ms": float(np.median(times["kernel_ms"])),
                "plain_ms": float(np.median(times["plain_ms"])),
                "sample_device_ms": dev_us.get("nee_sample_kernel", 0.0) / 1e3,
                "finish_device_ms": dev_us.get("nee_finish_kernel", 0.0) / 1e3,
                "walks_device_ms": dev_us.get("curry::", 0.0) / 1e3,
                "other_device_ms": dev_us.get("other", 0.0) / 1e3,
                "bound_bytes": bound, "bound_ms": bound / HBM * 1e3}
        print(json.dumps(line))
        for key, (share, rel) in ((k, v) for k, v in stats.items() if isinstance(v, tuple)):
            assert share <= MAX_DIFF_SHARE and rel <= MAX_REL, (key, share, rel)

