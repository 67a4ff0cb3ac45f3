"""The port's spans and stage boundaries (curry_pbrt_tpu_torch/utils/trace.py)
on the CPU.

  - spans: nesting and parents, totals by name, the ring of top-level
    trees and its bound; record_function ranges only while a profiler
    session records;
  - tracing off: a render through the chunk program makes no event, no
    record_function range and no synchronise, and a card's boundaries
    make no event;
  - the card's bookkeeping with a stand-in for torch.cuda.Event: captured
    boundaries are external events kept by the recording, eager ones are
    read when asked for, a replay's stages are led by `launch`;
  - the stage labels of a Cornell chunk (32², 4 spp, depth 3) are the same
    on the eager loop, in the program's recording (the fake recorder of
    tests/test_torch_render_graph.py) and in its replays, for the path and
    the direct-lighting integrators; on the CPU they partition the chunk;
  - images, segments and launch counters bit-equal with tracing on and
    off;
  - the train step's spans, and backward_over_pixels' times (keys as
    before, filled from the spans).

Tolerance: none. Tracing reads clocks; it changes no op.
"""

import itertools

import numpy as np
import pytest
import torch
from test_torch_render_graph import _bits, _plan, recorder  # noqa: F401 (a fixture)

from curry_pbrt_tpu_torch import render
from curry_pbrt_tpu_torch.interop import params_from_numpy
from curry_pbrt_tpu_torch.ops.kernels.intersect_kernel import LAUNCHES
from curry_pbrt_tpu_torch.parallel.mesh import backward_over_pixels, make_train_step, mse_pixel_loss
from curry_pbrt_tpu_torch.utils import trace

WORK = ("sample", "intersect", "shade", "nee", "film")


@pytest.fixture(autouse=True)
def fresh():
    """One intra-op thread; a trace record of this test's own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.reset()
    yield
    trace.reset()
    torch.set_num_threads(n)


def profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


class FakeEvent:
    """torch.cuda.Event's timing interface on a counter clock (1 ms a
    record)."""

    clock = itertools.count()
    made = []

    def __init__(self, enable_timing=False, blocking=False, interprocess=False, external=False):
        self.external = external
        self.t = None
        FakeEvent.made.append(self)

    def record(self, stream=None):
        self.t = float(next(FakeEvent.clock))

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.t - self.t


@pytest.fixture
def fake_events(monkeypatch):
    FakeEvent.made = []
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    return FakeEvent.made


def counting(monkeypatch, owner, name):
    """Wrap owner.name to count its calls; → the list of calls."""
    calls = []
    real = getattr(owner, name)

    def wrapped(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(owner, name, wrapped)
    return calls


# ---------------------------------------------------------------------------
# spans


def test_spans_nest_and_total():
    with trace.span("a") as a:
        with trace.span("b") as b:
            with trace.span("c") as c:
                pass
        with trace.span("b") as b2:
            pass
    assert a.parent is None and b.parent is a and c.parent is b and b2.parent is a
    assert [s.name for s in a.children] == ["b", "b"] and b.children == [c]
    assert [s.name for s in a.walk()] == ["a", "b", "c", "b"]
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= b2.start_ns
    assert b2.end_ns <= a.end_ns
    totals = trace.totals()
    assert set(totals) == {"a", "b", "c"}
    assert totals["b"][0] == 2 and totals["b"][1] == pytest.approx(b.seconds + b2.seconds)
    assert totals["a"] == (1, pytest.approx(a.seconds))
    assert trace.trees() == [a]  # only top-level spans enter the ring


def test_a_span_closes_when_its_block_raises():
    with pytest.raises(ValueError):
        with trace.span("outer"):
            with trace.span("inner"):
                raise ValueError("x")
    with trace.span("next") as nxt:
        pass
    assert nxt.parent is None and trace.totals()["inner"][0] == 1
    assert [s.name for s in trace.trees()] == ["outer", "next"]


def test_the_ring_keeps_the_last_trees():
    for i in range(trace.RING + 44):
        with trace.span(f"t{i % 3}"):
            pass
    trees = trace.trees()
    assert len(trees) == trace.RING
    assert [s.name for s in trees[:3]] == ["t2", "t0", "t1"]  # the 45th span first
    assert sum(n for n, _ in trace.totals().values()) == trace.RING + 44
    assert len(trace.trees("t0")) == sum(1 for s in trees if s.name == "t0")


def test_record_function_only_while_profiling(monkeypatch):
    calls = counting(monkeypatch, torch.profiler, "record_function")
    with trace.span("quiet"):
        pass
    assert calls == [] and not trace.tracing()
    with profiled() as prof:
        assert trace.tracing()
        with trace.span("loud"):
            with trace.span("louder"):
                torch.ones(4).sum()
    assert [a[0] for a in calls] == ["loud", "louder"]
    assert {"loud", "louder"} <= {e.key for e in prof.key_averages()}


# ---------------------------------------------------------------------------
# tracing off


def test_tracing_off_makes_no_event_range_or_sync(recorder, fake_events, monkeypatch):
    ranges = counting(monkeypatch, torch.profiler, "record_function")
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: syncs.append(a))
    _, plan = _plan()
    for _ in range(3):  # eager first chunk and recording, then replays
        render.render_plan(plan, show_progress=False)
    with trace.stages("cuda"):
        trace.stage("sample")
        trace.stage("film")
    assert trace.launch_mark("cuda") is None
    assert fake_events == [] and ranges == [] and syncs == []
    assert trace.stage_totals() == {}
    assert [t for tl in (p.timelines for p in plan.programs.programs.values()) for t in tl]
    assert trace.totals()["replay"][0] == 3 + 4 + 4 and trace.totals()["record"][0] == 2


# ---------------------------------------------------------------------------
# the card's bookkeeping, with a stand-in event


def test_captured_boundaries_are_external_events(fake_events):
    with trace.recording() as timelines:
        with trace.stages("cuda"):
            trace.stage("sample")
            trace.stage("intersect")
            trace.stage("sample")
    (tl,) = timelines
    assert tl.labels == ["sample", "intersect", "sample", None]
    assert [ev.external for _, ev in tl.marks] == [True] * 4 and len(fake_events) == 4
    assert trace.stage_totals() == {}  # nothing read without a traced replay
    with trace.span("replay") as rep:  # a replay records the captured events again
        start = trace.launch_mark("cuda")
        assert start is None  # not tracing
    with profiled():
        with trace.span("replay") as rep:
            start = trace.launch_mark("cuda")
            for _, ev in tl.marks:
                ev.record()
            trace.replayed(start, timelines)
    assert not start.external
    assert rep.stages == [("launch", 1.0), ("sample", 1.0), ("intersect", 1.0), ("sample", 1.0)]
    assert trace.stage_totals() == {"launch": 1.0, "sample": 2.0, "intersect": 1.0}


def test_eager_boundaries_are_read_when_asked(fake_events):
    with profiled():
        with trace.span("chunk") as chunk:
            with trace.stages("cuda"):
                trace.stage("nee")
                trace.stage("film")
    assert [ev.external for ev in fake_events] == [False] * 3
    assert chunk.stages == []  # read lazily: no wait in the chunk
    assert trace.stage_totals() == {"nee": 1.0, "film": 1.0}
    assert chunk.stages == [("nee", 1.0), ("film", 1.0)] and chunk.stage_ms() == {
        "nee": 1.0, "film": 1.0}


# ---------------------------------------------------------------------------
# a render's stages


def chunk_labels(node):
    """The stage labels read under one chunk span, in order."""
    return [label for s in node.walk() for label, _ in s.stages]


@pytest.mark.parametrize("integrator", ["path", "directlighting"])
def test_the_stages_of_a_chunk(recorder, integrator):
    _, plan = _plan(integrator=integrator)
    with profiled():
        render.render_plan(plan, show_progress=False, graph=False)
    eager = trace.trees("render_plan")[-1]
    chunks = [c for c in eager.children if c.name == "chunk"]
    assert [c.name for c in eager.children] == ["prepare"] + ["chunk"] * 4 + ["readback"]
    labels = chunk_labels(chunks[0])
    assert all(chunk_labels(c) == labels for c in chunks)
    assert labels[:3] == ["sample", "film", "shade"] and labels[-1] == "film"
    assert set(labels) == set(WORK)
    if integrator == "path":  # 3 bounces of 5 stages, the final slim hit
        assert labels[3:-1] == ["sample", "intersect", "shade", "nee", "shade"] * 3 + ["intersect"]
    else:  # 3 levels of hit, Halton, lobes, NEE, the first two then the delta branch's
        level = ["intersect", "sample", "shade", "nee"]
        assert labels[3:-1] == (level + ["sample", "shade"]) * 2 + level
    # the CPU's host-clock stages partition the chunk
    for c in chunks:
        (e,) = c.children
        assert 0 < sum(ms for _, ms in e.stages) <= 1e3 * e.seconds

    # the program records the same boundaries, and a replay reads them again
    render.render_plan(plan, show_progress=False)  # eager first chunk, records
    for prog in plan.programs.programs.values():
        (tl,) = prog.timelines
        assert tl.labels == labels + [None]
    with profiled():
        render.render_plan(plan, show_progress=False)
    replayed = trace.trees("render_plan")[-1]
    assert trace.fully_replayed(replayed) and not trace.fully_replayed(eager)
    for c in (c for c in replayed.children if c.name == "chunk"):
        assert [g.name for g in c.children] == ["replay"] and chunk_labels(c) == labels


def test_tent_film_chunks_splat_after_their_stages(recorder):
    _, plan = _plan(filter="triangle")
    for _ in range(2):
        render.render_plan(plan, show_progress=False)
    with profiled():
        render.render_plan(plan, show_progress=False)
    last = trace.trees("render_plan")[-1]
    assert trace.fully_replayed(last)
    for c in (c for c in last.children if c.name == "chunk"):
        assert [g.name for g in c.children] == ["replay", "splat"]
        assert chunk_labels(c)[-1] == "film"


def test_tracing_changes_no_result(recorder):
    _, plan = _plan()
    runs = {}
    for on in (False, True, False, True):  # records on the first, replays after
        LAUNCHES.clear()
        if on:
            with profiled():
                img, seg = render.render_plan(plan, show_progress=False, count_rays=True)
        else:
            img, seg = render.render_plan(plan, show_progress=False, count_rays=True)
        runs.setdefault(on, []).append((_bits(img), seg, dict(LAUNCHES)))
    first = runs[False][0]
    for img, seg, launches in runs[False] + runs[True]:
        assert np.array_equal(img, first[0]) and seg == first[1] and launches == first[2]


def test_a_pass_span_of_every_render(recorder):
    _, plan = _plan()
    render.render_plan(plan, show_progress=False)
    render.render_plan(plan, show_progress=False)
    warm, replayed = trace.trees("render_plan")
    assert [[g.name for g in c.children] for c in warm.children if c.name == "chunk"] == [
        ["eager", "record"], ["replay"], ["replay"], ["record", "replay"]]
    assert not trace.fully_replayed(warm) and trace.fully_replayed(replayed)
    assert trace.traced_pass_ms() is None  # no replay was traced
    assert trace.totals()["render_plan"] == (2, pytest.approx(warm.seconds + replayed.seconds))
    assert "render_plan" in trace.summary() and "record" in trace.summary()


# ---------------------------------------------------------------------------
# the train step


def test_the_train_step_fills_times_from_its_spans():
    scene, plan = _plan()
    params = params_from_numpy(scene.init_params, "cpu")
    key = next(iter(params["textures"]))
    params["textures"][key] = params["textures"][key].clone().requires_grad_(True)
    po, px = render.pixel_arrays(plan)
    target = torch.full((po.shape[0], 3), 0.5)
    times = {}
    backward_over_pixels(plan, params, po, px, mse_pixel_loss(target), times=times)
    assert set(times) == {"forward_s", "backward_s"}
    t = trace.totals()
    assert times["forward_s"] == pytest.approx(t["forward"][1])
    assert times["backward_s"] == pytest.approx(t["backward"][1])
    assert t["forward"][0] == t["backward"][0] == 4  # sub-chunks of 300 pixels

    trace.reset()
    step = make_train_step(plan, torch.optim.Adam([params["textures"][key]], lr=0.05))
    times = {}
    step(params, target, po, px, times=times)
    assert set(times) == {"forward_s", "backward_s"}
    (tree,) = trace.trees()
    assert tree.name == "train_step"
    assert [c.name for c in tree.children] == ["forward", "backward"] * 4 + ["optimizer"]
    assert times["backward_s"] == pytest.approx(
        sum(c.seconds for c in tree.children if c.name == "backward"))
