"""The readers of the program's own spans and stages
(curry_pbrt_tpu_torch/utils/trace.py): their units and layers are
BENCHMARK.json's; they read nothing off the card or where nothing was
traced; on a CPU render whose chunk program is recorded by a stand-in
recorder, prepare_ms.render and record_s.render read the trace's spans."""

import json
import statistics

import pytest
import torch

from portbench.bench import ROOT, load_module
from portbench.tests.helpers import SEED, tiny_cell

STAGES = ("launch", "sample", "intersect", "nee", "shade", "film")
READERS = [f"{s}_ms.render" for s in STAGES] + ["prepare_ms.render", "record_s.render"]


@pytest.fixture
def trace():
    from curry_pbrt_tpu_torch.utils import trace

    trace.reset()
    yield trace
    trace.reset()


@pytest.fixture
def recorder(monkeypatch):
    """The chunk program's recording seam on the CPU: a recording runs the
    chunk once, a replay runs it again into the recorded outputs."""
    from curry_pbrt_tpu_torch import render

    def record(fn):
        outs = fn()

        def replay():
            saved = [dict(c) for c in render._COUNTERS]
            for out, new in zip(outs, fn()):
                out.copy_(new)
            for counter, was in zip(render._COUNTERS, saved):
                counter.update(was)

        return replay, outs

    monkeypatch.setattr(render, "_recorder", lambda device: record)


@pytest.mark.parametrize("name", READERS)
def test_the_reader_is_benchmark_jsons(name):
    spec = next(m for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]
                if m["name"] == name)
    reader = load_module("metrics", name)
    assert (reader.UNIT, reader.LAYER, reader.MOVES) == (spec["unit"], spec["layer"], spec["moves"])
    assert spec["source"] == "program_span"


@pytest.mark.parametrize("name", READERS)
def test_nothing_traced_nothing_read(name, trace):
    reader = load_module("metrics", name)
    assert reader.read({"card": "NVIDIA H100 80GB HBM3"}) is None
    assert reader.read({"card": "cpu"}) is None


def test_a_cpu_render_reads_its_spans(trace, recorder):
    from curry_pbrt_tpu_torch.render import plan_render, render_plan
    from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file

    cell = tiny_cell("cornell_tex_512.render")
    scene = compile_scene_file(cell.scene_path, cell.overrides(SEED))
    plan = plan_render(scene, device="cpu", chunk_pixels=100)  # 256 pixels: 3 chunks
    for _ in range(4):
        render_plan(plan, show_progress=False)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        render_plan(plan, show_progress=False)  # replays traced: host-clock stages
    render_plan(plan, show_progress=False, graph=False)
    passes = trace.trees("render_plan")
    replayed = [p for p in passes if trace.fully_replayed(p)]
    assert len(passes) == 6 and len(replayed) == 4
    prepare = load_module("metrics", "prepare_ms.render").read({"card": "cpu"})
    assert prepare == statistics.median(
        1e3 * c.seconds for p in replayed for c in p.children if c.name == "prepare")
    n, seconds = trace.totals()["record"]
    assert n == 2 and load_module("metrics", "record_s.render").read({"card": "cpu"}) == seconds
    # the CPU's stages are host time: no stage reader reads them as the card's
    assert set(trace.traced_pass_ms()) == {"sample", "intersect", "nee", "shade", "film"}
    for s in STAGES:
        assert load_module("metrics", f"{s}_ms.render").read({"card": "cpu"}) is None
