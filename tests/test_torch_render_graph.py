"""render_plan's chunk program (render.ChunkPrograms, the counterpart of the
JAX package's one-dispatch `_render_all` / `_render_all_splat`) on the CPU.

The CPU has no CUDA graphs, so each test replaces the recording seam
(render._recorder) with a recorder of its own: it runs the chunk function
once at recording, as a capture runs the Python once, and every replay
runs it again into the same output tensors with the host counters put
back, as a replay runs no Python. That drives the program's bookkeeping —
the eager first chunk, one program per chunk shape, the static inputs and
params tree, the outputs, the launch counters — on the plain versions.

  - cornell_tex at 32², 4 spp, depth 3, box film, chunks of 300 pixels (a
    remainder of 124): image, segments and NaN counts bit-equal to the
    eager loop on the recording pass and on an all-replay pass; exactly two
    programs;
  - a second pass with the texture scaled against the eager render with
    those params (stale params would show); a params tree of another
    shape, or with another key, raises;
  - the tent film bit-equal to its eager loop;
  - the counters' change over a recording added once a replay, and put
    back when a recording fails (which raises);
  - a one-chunk plan records in its first pass and only replays after it;
    render_scene never records;
  - the recorded path against the JAX package's render_scene (its
    `_render_all`) at the same size, under the cross-backend tolerance of
    tests/test_torch_render.py (the JAX package's tests/test_golden.py
    allclose(1e-4, 1e-4), at most 1% of values outside it, the sum within
    1e-3 relative);
  - the chunk function issues no op that reads a value back to the host
    (which a recording would refuse), on the brute intersectors, so that
    the plain versions' host-side walks stay out of it.

Tolerance: none but the JAX comparison's. The program runs the eager
loop's ops on the same inputs in the same order.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from curry_pbrt_tpu.render import render_scene as jax_render
from curry_pbrt_tpu.sceneio.compiler import compile_scene_file as jax_compile
from curry_pbrt_tpu_torch import render
from curry_pbrt_tpu_torch.interop import params_from_numpy
from curry_pbrt_tpu_torch.ops.kernels.aggregate import RAY_SORTS
from curry_pbrt_tpu_torch.ops.kernels.intersect_kernel import LAUNCHES
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file

REPO = Path(__file__).resolve().parents[1]
SCENE = REPO / "scenes" / "cornell_tex.pbrt"
SMALL = {"resolution": (32, 32), "spp": 4, "max_depth": 3}
CHUNK = 300  # 1,024 pixels: three chunks of 300 and one of 124
RTOL = ATOL = 1e-4
MAX_OUTLIER_FRAC = 0.01
SUM_RTOL = 1e-3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread (the tier-1 run shares the host's cores among
    its xdist workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def recorder(monkeypatch):
    """Replace the recording seam; → the list of recordings made."""
    made = []

    def record(fn):
        outs = fn()
        made.append(outs)

        def replay():
            saved = [dict(c) for c in render._COUNTERS]
            for out, new in zip(outs, fn()):
                out.copy_(new)
            for counter, was in zip(render._COUNTERS, saved):
                counter.update(was)

        return replay, outs

    monkeypatch.setattr(render, "_recorder", lambda device: record)
    return made


def _plan(**ov):
    scene = compile_scene_file(SCENE, overrides={**SMALL, **ov})
    return scene, render.plan_render(scene, device="cpu", chunk_pixels=CHUNK)


def _bits(img):
    return np.ascontiguousarray(img, dtype=np.float32).view(np.uint32)


def _poison(monkeypatch):
    """Every 7th sample of a chunk's radiance NaN, so that the NaN counts
    are not all 0."""
    real = render._chunk_sample_radiance

    def poisoned(plan, params, po, px):
        radiance, film_xy, segments = real(plan, params, po, px)
        bad = torch.arange(radiance.shape[0], device=radiance.device) % 7 == 3
        return torch.where(bad[:, None], float("nan"), radiance), film_xy, segments

    monkeypatch.setattr(render, "_chunk_sample_radiance", poisoned)


def _spy(monkeypatch, owner, name, seen, pick):
    """Wrap owner.name to append pick(its result) to `seen`."""
    real = getattr(owner, name)

    def spied(*a, **kw):
        out = real(*a, **kw)
        seen.append(pick(out))
        return out

    monkeypatch.setattr(owner, name, spied)


def test_box_film_is_the_eager_loop(recorder, monkeypatch, caplog):
    _poison(monkeypatch)
    scene, plan = _plan()
    eager_nans = []
    with monkeypatch.context() as m:
        _spy(m, render, "_render_chunk", eager_nans, lambda out: out[1].clone())
        eager, seg_e = render.render_plan(plan, show_progress=False, count_rays=True,
                                          graph=False)
    eager_log = [r.getMessage() for r in caplog.records if "NaN" in r.getMessage()]
    assert eager_log and not recorder and plan.programs is None
    assert sum(map(torch.sum, eager_nans)) > 0
    nans = []
    _spy(monkeypatch, render.ChunkPrograms, "run", nans, lambda out: out[1].clone())
    for n in (1, 2):
        caplog.clear()
        img, seg = render.render_plan(plan, show_progress=False, count_rays=True)
        assert np.array_equal(_bits(img), _bits(eager)) and seg == seg_e, n
        assert [r.getMessage() for r in caplog.records if "NaN" in r.getMessage()] == eager_log
    assert len(nans) == 8 and all(torch.equal(a, b) for a, b in zip(nans, eager_nans * 2))
    assert len(recorder) == 2 and sorted(plan.programs.programs) == [("box", 124), ("box", 300)]
    assert plan.programs.replays == 3 + 4


def test_second_pass_takes_its_params(recorder):
    scene, plan = _plan()
    render.render_plan(plan, show_progress=False)
    params = params_from_numpy(scene.init_params, "cpu")
    key = next(iter(params["textures"]))
    params["textures"][key] = params["textures"][key] * 0.5
    params["light_L"] = params["light_L"] * 1.25
    replayed, seg_r = render.render_plan(plan, params, show_progress=False, count_rays=True)
    assert len(recorder) == 2 and plan.programs.replays == 3 + 4
    _, fresh = _plan()
    eager, seg_e = render.render_plan(fresh, params, show_progress=False, count_rays=True,
                                      graph=False)
    assert np.array_equal(_bits(replayed), _bits(eager)) and seg_r == seg_e
    assert not np.array_equal(_bits(replayed), _bits(render.render_plan(plan, show_progress=False)))


@pytest.mark.parametrize("change", ["texture shape", "extra key", "dtype"])
def test_a_params_tree_of_another_layout_raises(recorder, change):
    scene, plan = _plan()
    render.render_plan(plan, show_progress=False)
    params = params_from_numpy(scene.init_params, "cpu")
    key = next(iter(params["textures"]))
    if change == "texture shape":
        params["textures"][key] = params["textures"][key][1:]
    elif change == "extra key":
        params["textures"]["another"] = params["textures"][key]
    else:
        params["light_L"] = params["light_L"].double()
    with pytest.raises(ValueError, match="recorded with"):
        render.render_plan(plan, params, show_progress=False)
    assert len(recorder) == 2  # nothing recorded again


def test_tent_film_is_the_eager_loop(recorder):
    _, plan = _plan(filter="triangle")
    assert plan.scene.settings.filter == "triangle"
    eager, seg_e = render.render_plan(plan, show_progress=False, count_rays=True, graph=False)
    for _ in range(2):
        img, seg = render.render_plan(plan, show_progress=False, count_rays=True)
        assert np.array_equal(_bits(img), _bits(eager)) and seg == seg_e
    assert len(recorder) == 2
    assert sorted(plan.programs.programs) == [("triangle", 124), ("triangle", 300)]


def test_a_replay_adds_the_recordings_counts(recorder, monkeypatch):
    """The plain versions launch nothing, so the chunk function here counts
    three launches and one sorted traversal a call, as a kernel path
    would."""
    real = render._render_chunk

    def counting(plan, params, po, px):
        LAUNCHES["tri_closest"] += 3
        RAY_SORTS["traversals"] += 1
        return real(plan, params, po, px)

    monkeypatch.setattr(render, "_render_chunk", counting)
    monkeypatch.setitem(LAUNCHES, "tri_closest", 0)
    monkeypatch.setitem(RAY_SORTS, "traversals", 0)
    _, plan = _plan()
    render.render_plan(plan, show_progress=False, graph=False)
    eager = (LAUNCHES["tri_closest"], RAY_SORTS["traversals"])
    assert eager == (12, 4)
    for n in (1, 2):
        LAUNCHES["tri_closest"] = RAY_SORTS["traversals"] = 0
        render.render_plan(plan, show_progress=False)
        assert (LAUNCHES["tri_closest"], RAY_SORTS["traversals"]) == eager, n
    for prog in plan.programs.programs.values():
        assert sorted((c is LAUNCHES, name, n) for c, name, n in prog.counts) == [
            (False, "traversals", 1), (True, "tri_closest", 3)]
    po, px = render.pixel_arrays(plan)
    plan.programs.run("box", None, None, po[:CHUNK], px[:CHUNK])  # one replay
    assert (LAUNCHES["tri_closest"], RAY_SORTS["traversals"]) == (eager[0] + 3, eager[1] + 1)


def test_a_one_chunk_plan_records_in_its_first_pass(recorder):
    """The program is recorded right after the plan's eager first chunk, in
    the same call: a warm-up pass leaves every later pass to replays."""
    scene = compile_scene_file(SCENE, overrides=SMALL)
    plan = render.plan_render(scene, device="cpu")  # 1,024 pixels: one chunk
    eager = render.render_plan(plan, show_progress=False, graph=False)
    first = render.render_plan(plan, show_progress=False)
    assert len(recorder) == 1 and plan.programs.replays == 0
    assert sorted(plan.programs.programs) == [("box", 1024)]
    second = render.render_plan(plan, show_progress=False)
    assert len(recorder) == 1 and plan.programs.replays == 1
    assert np.array_equal(_bits(first), _bits(eager)) and np.array_equal(_bits(second), _bits(eager))


def test_a_failed_recording_raises_and_leaves_the_counters(monkeypatch):
    """A recording that fails raises out of render_plan, records no
    program, and puts back the counts its chunk made while recording."""
    def record(fn):
        fn()
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(render, "_recorder", lambda device: record)
    real = render._render_chunk

    def counting(plan, params, po, px):
        LAUNCHES["tri_closest"] += 3
        RAY_SORTS["traversals"] += 1
        return real(plan, params, po, px)

    monkeypatch.setattr(render, "_render_chunk", counting)
    monkeypatch.setitem(LAUNCHES, "tri_closest", 0)
    monkeypatch.setitem(RAY_SORTS, "traversals", 0)
    _, plan = _plan()
    with pytest.raises(RuntimeError, match="capturing"):
        render.render_plan(plan, show_progress=False)
    assert plan.programs.warm and not plan.programs.programs
    assert (LAUNCHES["tri_closest"], RAY_SORTS["traversals"]) == (3, 1)  # the eager chunk's


def test_render_scene_runs_eagerly(recorder):
    """render_scene's plan lives for one pass, which a recording could not
    pay back: it records nothing, and a fresh plan's one render_plan pass,
    which records, gives the same image."""
    scene = compile_scene_file(SCENE, overrides=SMALL)
    eager = render.render_scene(scene, device="cpu", chunk_pixels=CHUNK, show_progress=False)
    assert recorder == []
    plan = render.plan_render(scene, device="cpu", chunk_pixels=CHUNK)
    img = render.render_plan(plan, show_progress=False)
    assert len(recorder) == 2 and np.array_equal(_bits(img), _bits(eager))


def test_recorded_path_matches_jax(recorder):
    js = jax_compile(SCENE, overrides=SMALL)
    ref = jax_render(js, show_progress=False, intersector="pallas")
    scene, plan = _plan()
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, js.init_params), "cpu")
    render.render_plan(plan, params, show_progress=False)
    img = render.render_plan(plan, params, show_progress=False)  # replays alone
    assert plan.programs.replays == 3 + 4
    assert img.shape == ref.shape and np.isfinite(img).all()
    outside = ~np.isclose(img, ref, rtol=RTOL, atol=ATOL)
    assert outside.mean() <= MAX_OUTLIER_FRAC, (outside.sum(), np.abs(img - ref).max())
    assert abs(img.sum() - ref.sum()) <= SUM_RTOL * abs(ref.sum())


# ops that read a tensor's value or size back to the host: a CUDA graph
# cannot record them (torch.tensor(...) of host data, lift_fresh, is a copy
# from the host)
HOST_READS = {"_local_scalar_dense", "nonzero", "masked_select", "masked_scatter", "is_nonzero",
              "equal", "unique", "_unique2", "unique_dim", "unique_consecutive", "argwhere",
              "lift_fresh", "repeat_interleave"}


class _HostReads(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name in HOST_READS:
            self.seen.append(str(func))
        if name in ("index", "index_put", "index_put_", "_index_put_impl_") and any(
                i is not None and i.dtype == torch.bool for i in args[1]):
            self.seen.append(f"{func} with a boolean index")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name,ov", [
    ("cornell_tex", {}),
    ("spheres", {}),  # direct lighting
    ("cornell_tex", {"filter": "triangle"}),
    ("mesh10k", {"resolution": (8, 8), "spp": 2}),
])
def test_chunk_reads_nothing_back_to_the_host(name, ov):
    scene = compile_scene_file(REPO / "scenes" / f"{name}.pbrt",
                               overrides={**SMALL, "resolution": (8, 8), **ov})
    plan = render.plan_render(scene, device="cpu", intersector="brute")
    params = params_from_numpy(scene.init_params, "cpu")
    po, px = render.pixel_arrays(plan)
    fn = render._chunk_taps if scene.settings.filter == "triangle" else render._render_chunk
    with torch.no_grad(), _HostReads() as mode:
        outs = fn(plan, params, po, px)
    assert mode.seen == [], sorted(set(mode.seen))
    assert all(torch.isfinite(o.float()).all() for o in outs)
