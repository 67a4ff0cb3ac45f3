"""The port's per-stage profiler (curry_pbrt_tpu_torch/tools/profile_stages.py)
on the CPU: its JSON line lists the JAX tool's nine stages
(tools/profile_stages.py) and the three it adds from tools/profile_bench.py,
in order, each with a finite wall (device ms and launches are None off the
card); and its `intersect closest` stage traces the rays it was given: the
hits of its probe rays equal the port's brute intersector's (prim ids
equal, t within the JAX brute tests' rtol 1e-6), and one repetition's carry
is o + 1e-6·t of those hits.
"""

import io
import json
import math
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from curry_pbrt_tpu_torch.render import make_intersectors, plan_render
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file
from curry_pbrt_tpu_torch.tools import profile_stages as PS

JAX_STAGES = ["intersect closest", "predicate", "halton 8 dims", "shade_eval",
              "shade_sample_nondelta", "shade_sample (full)", "light sample_li", "NEE total",
              "full bounce (isect+NEE+sample)"]
ARGS = ["--device", "cpu", "--n", "4096", "--scene", "cornell.pbrt", "--res", "32", "32",
        "--spp", "4", "--depth", "2", "--reps", "1"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_json_line_lists_every_stage():
    out = io.StringIO()
    with redirect_stdout(out):
        result = PS.main(ARGS)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line["stages"]) == JAX_STAGES + ["camera rays", "film", "chunk"]
    assert line["n"] == 4096 and line["device"] == {"name": "cpu", "power_limit": None}
    for name, r in line["stages"].items():
        assert math.isfinite(r["wall_ms"]) and r["wall_ms"] > 0, name
        assert r["device_ms"] is None and r["launches"] is None, name
        assert r["finite"], name
    assert result["stages"]["chunk"]["out"].shape == (32 * 32, 3)  # one chunk: the whole film


def test_intersect_stage_hits_equal_brute():
    scene = compile_scene_file(PS.SCENES / "cornell.pbrt",
                               overrides={"resolution": (32, 32), "spp": 4, "max_depth": 2})
    stages = PS.Stages(plan_render(scene, device="cpu"), 4096, seed=0)
    o, d = PS.make_rays(4096, 0, "cpu")
    assert torch.equal(stages.o, o) and torch.equal(stages.d, d)
    inter, _, _ = make_intersectors(scene, "cpu", "brute")
    ref = inter(o, d, stages.t_max)
    got = stages.hit
    np.testing.assert_array_equal(got.prim.numpy(), ref.prim.numpy())
    hit = ref.prim.numpy() >= 0
    assert hit.mean() > 0.5
    np.testing.assert_allclose(got.t.numpy()[hit], ref.t.numpy()[hit], rtol=1e-6, atol=0)
    body, init, _ = stages.bodies()["intersect closest"]
    o1, d1 = body(init)
    np.testing.assert_allclose(o1.numpy(), (o + 1e-6 * ref.t[:, None]).numpy(), rtol=1e-6)
    assert torch.equal(d1, d)
