"""The path continuation's kernel on the card (csrc/shade.cu through
ops/kernels/shade.py) against the plain path, continue_path_plain. Imports
nothing of JAX, so that it runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_shade_card.py -q -s

  - every bounce of the middle chunk of each benchmark scene at its cell's
    size (cornell_tex 512², 64 spp, depth 5; mesh10k 1024², 32 spp, depth 8:
    4,194,304 lanes a call), and of a small scene whose uber materials take
    both of bsdf_sample's buckets: the kernel's o, d, beta, specular and
    active bit-equal to the plain path's on every lane (chip_smoke.py's
    check_shade), with the call's ms both ways (CUDA events, in turns), the
    kernel's device ms (torch.profiler) and its bytes bound at 3.35 TB/s
    printed as one JSON line a bounce;
  - a call advances LAUNCHES["shade_continue"] by one and counts
    `shade_kernel` on the open span; with autograd on, the plain path and
    no launch;
  - a render through the chunk program (record, then replay) equal to the
    eager render, both through the kernel, which counts `shade_kernel` and
    never `shade_plain`.

The kernel keeps the plain path's order of operations and is built like
every csrc kernel (-fmad=false, IEEE division and square root), so nothing
differs in any bit. Without a card each test skips (marked cuda).
"""

import functools
import json
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

from curry_pbrt_tpu_torch import render
from curry_pbrt_tpu_torch.interop import params_from_numpy
from curry_pbrt_tpu_torch.models import integrators as I
from curry_pbrt_tpu_torch.ops.kernels.intersect_kernel import LAUNCHES
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file, compile_scene_string
from curry_pbrt_tpu_torch.utils import trace

REPO = Path(__file__).resolve().parents[1]
SCENES = {"cornell_tex": ("portbench/scenes/cornell_tex.pbrt", 5),
          "mesh10k": ("portbench/scenes/mesh10k.pbrt", 8)}
CELL_SIZE = {"cornell_tex": (512, 64), "mesh10k": (1024, 32)}  # resolution, spp
HBM = 3.35e12  # bytes/s, H100 SXM
# uber with both buckets (lambert_r, ggx_r, spec_r; lambert_r, ggx_r,
# spec_t; spec_t passthrough, lambert_r), glass, mirror and plastic
MIXED = """LookAt 0 1 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [45]
Sampler "halton" "integer pixelsamples" [16]
Film "image" "integer xresolution" [64] "integer yresolution" [64]
Integrator "path" "integer maxdepth" [7]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [5 5 5]
  Shape "trianglemesh" "integer indices" [0 1 2 2 3 0]
    "point P" [-0.5 2 -0.5  0.5 2 -0.5  0.5 2 0.5  -0.5 2 0.5]
AttributeEnd
Material "uber" "rgb Kd" [0.3 0.4 0.5] "rgb Ks" [0.2 0.2 0.2] "rgb Kr" [0.3 0.3 0.3] "float roughness" [0.05]
Shape "trianglemesh" "integer indices" [0 1 2 2 3 0]
  "point P" [-2 -0.5 -2  2 -0.5 -2  2 -0.5 2  -2 -0.5 2]
Material "glass"
AttributeBegin
  Translate 0.6 0 0
  Shape "sphere" "float radius" [0.3]
AttributeEnd
Material "uber" "rgb Kd" [0.4 0.2 0.2] "rgb Kt" [0.5 0.5 0.5] "float index" [1.33]
AttributeBegin
  Translate -0.6 0 0
  Shape "sphere" "float radius" [0.3]
AttributeEnd
Material "uber" "rgb Kd" [0.4 0.2 0.2] "rgb Ks" [0 0 0] "rgb opacity" [0.6 0.6 0.6]
AttributeBegin
  Translate 0 0.2 0.8
  Shape "sphere" "float radius" [0.3]
AttributeEnd
Material "mirror"
Shape "trianglemesh" "integer indices" [0 1 2]
  "point P" [-1 -0.4 0.5  -0.2 0.6 0.5  -0.6 -0.4 1]
Material "plastic" "rgb Kd" [0.3 0.4 0.6] "rgb Ks" [0.3 0.3 0.3] "float roughness" [0.1]
Shape "trianglemesh" "integer indices" [0 1 2]
  "point P" [1 -0.4 0.5  0.2 0.6 0.5  0.6 -0.4 1]
WorldEnd
"""

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/shade.cu has no CPU mode")
    return torch.device("cuda")


def _plan(name, res=None, spp=None, chunk_pixels=None):
    if name == "mixed":
        scene = compile_scene_string(MIXED)
    else:
        path, depth = SCENES[name]
        scene = compile_scene_file(REPO / path, {"resolution": (res, res), "spp": spp,
                                                 "max_depth": depth})
    plan = render.plan_render(scene, device="cuda", chunk_pixels=chunk_pixels)
    return plan, params_from_numpy(scene.init_params, "cuda")


@functools.lru_cache(maxsize=None)
def _smoke():
    """chip_smoke.py's functions: its phase 7c makes the same check at
    full size."""
    return runpy.run_path(str(REPO / "chip_smoke.py"), run_name="chip_smoke")


def _calls(plan, params, pixels, start=0):
    """The arguments of every continue_path call of the plan's chunk over
    `pixels` pixels from `start`, one a bounce, by name, its tensors
    copied and its shading frame given."""
    return _smoke()["path_calls"](plan, params, start, pixels, "continue_path")


@pytest.mark.parametrize("name", sorted(SCENES) + ["mixed"])
def test_kernel_matches_the_plain_path_at_every_bounce(card, name):
    """At the cell's size, the chunk that holds the frame's middle row (the
    first chunk of the mesh frame is sky); the mixed scene whole."""
    if name == "mixed":
        plan, params = _plan(name)
        calls = _calls(plan, params, 64 * 64)
    else:
        res, spp = CELL_SIZE[name]
        plan, params = _plan(name, res, spp)
        C = plan.chunk_pixels
        calls = _calls(plan, params, C, start=(res * res // 2) // C * C)
    with torch.no_grad():
        assert I.continuation_refusal(plan.ctx, card) is None
    assert len(calls) == plan.scene.settings.max_depth
    dev_name = torch.cuda.get_device_name(0)
    for bounce, c in enumerate(calls):
        line = _smoke()["check_shade"](f"{name} bounce {bounce}", c)  # raises where a bit differs
        line["bound_ms"] = line["bytes"] / HBM * 1e3
        print(json.dumps({"scene": name, "bounce": bounce, "device": dev_name, **line}))
        assert line["differ"] == 0, line


def test_each_call_launches_the_kernel_once(card):
    plan, params = _plan("mesh10k", 32, 4)
    c, *_ = _calls(plan, params, 32 * 32)
    before = dict(LAUNCHES)
    with torch.no_grad(), trace.span("shade_probe") as node:
        I.continue_path(**c)
        I.continue_path(**c)
    assert LAUNCHES["shade_continue"] - before["shade_continue"] == 2
    assert node.counts == {"shade_kernel": 2}
    with torch.enable_grad(), trace.span("shade_probe") as node:
        I.continue_path(**c)  # autograd on: the plain path
    assert LAUNCHES["shade_continue"] - before["shade_continue"] == 2
    assert node.counts == {"shade_plain": 1}


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
    assert counts.get(("record", "shade_kernel"), 0) > 0
    assert not any(counter == "shade_plain" for _, counter in counts)
    calls = LAUNCHES["shade_continue"] - before["shade_continue"]
    assert calls == 2 * 5 * SCENES[name][1]  # 2 passes, ceil(4096 / 1000) chunks, a call a bounce
