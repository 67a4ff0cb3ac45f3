"""The port's stage boundaries on the card (curry_pbrt_tpu_torch/utils/trace.py):
the timing events captured into a chunk program split its replay. Imports
nothing of JAX, so that it runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_trace_card.py -q

cornell_tex at 512 x 256, 64 spp, depth 5 (two chunks of the headline's
4,194,304 rays): a warm-up pass records the program, an untraced pass
replays it, then a pass replays each chunk inside a profiler session of its
own (as the benchmark's traced pass does). That pass's stages are all
read, led by `launch`; the five work stages sum to within 2% of the
sessions' device busy time (the events sit between kernels, so the stages
also hold the graph's gaps between kernels, and the busy time the static
input copies); its image is the untraced pass's bit for bit. Without a
card each test skips (marked cuda).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from curry_pbrt_tpu_torch import render
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file
from curry_pbrt_tpu_torch.utils import trace

REPO = Path(__file__).resolve().parents[1]
OVERRIDES = {"resolution": (512, 256), "spp": 64, "max_depth": 5}
WORK = ("sample", "intersect", "shade", "nee", "film")

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and their event nodes have no CPU mode")


def _busy_us(prof) -> float:
    """The union of the session's device records' intervals."""
    total, end = 0.0, None
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    for a, b in spans:
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total


def test_a_traced_replay_splits_the_pass(card, monkeypatch):
    trace.reset()
    scene = compile_scene_file(REPO / "scenes" / "cornell_tex.pbrt", overrides=OVERRIDES)
    plan = render.plan_render(scene, device="cuda")
    render.render_plan(plan, show_progress=False)  # records
    untraced = render.render_plan(plan, show_progress=False)
    assert trace.traced_pass_ms() is None
    busy = []
    real = render.ChunkPrograms.run

    def run(self, *a, **kw):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            out = real(self, *a, **kw)
            torch.cuda.synchronize()
        busy.append(_busy_us(prof))
        return out

    monkeypatch.setattr(render.ChunkPrograms, "run", run)
    traced = render.render_plan(plan, show_progress=False)
    ms = trace.traced_pass_ms()
    assert len(busy) == 2 and ms is not None and set(ms) == {"launch", *WORK}
    assert all(v > 0 for v in ms.values())
    work, busy_ms = sum(ms[k] for k in WORK), sum(busy) / 1e3
    assert abs(work - busy_ms) <= 0.02 * busy_ms, (ms, busy_ms)
    assert set(trace.stage_totals()) == set(ms)
    assert np.array_equal(np.ascontiguousarray(traced).view(np.uint32),
                          np.ascontiguousarray(untraced).view(np.uint32))
