"""render_plan's chunk program on the card: real CUDA graphs against the
eager loop. Imports nothing of JAX, so that it runs where only the port is
installed:

    python -m pytest --noconftest tests/test_torch_render_graph_card.py -q

  - one K1 launch (the ctypes library, its own CUDA runtime) and one BVH
    walk (a memset and two launches) recorded onto a capture stream and
    replayed on new inputs: bit-equal to eager launches on those inputs;
  - cornell_tex (the small-table walk), mesh10k (the warp walk) and mesh10k
    through intersector="bvh" (the live-ray BVH walk) at 64², 8 spp, depth
    4, in render chunks of 1,000 pixels (four and a remainder of 96): an
    eager pass, then two passes through the program (the first records
    both chunk shapes, the second only replays), each image bit-equal to
    the eager one, with its segments and every launch counter equal, and
    the path's walk launched;
  - a chunk function that reads a value back to the host raises at its
    recording, and render_plan returns nothing; an eager render after it
    is unchanged.

Tolerance: none. A replay runs the eager loop's kernels on the same inputs
in the same order. Without a card each test skips (marked cuda).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from curry_pbrt_tpu_torch import render
from curry_pbrt_tpu_torch.ops.bvh import build_flat_bvh, device_bvh
from curry_pbrt_tpu_torch.ops.kernels import intersect_kernel as K
from curry_pbrt_tpu_torch.ops.kernels.aggregate import RAY_SORTS, plan_tri_kernel
from curry_pbrt_tpu_torch.ops.kernels.bvh_kernel import bvh_closest
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file

REPO = Path(__file__).resolve().parents[1]
OVERRIDES = {"resolution": (64, 64), "spp": 8, "max_depth": 4}
CHUNK = 1000

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the traversal kernels have no CPU mode")


def _bits(img):
    return np.ascontiguousarray(img, dtype=np.float32).view(np.uint32)


def _rays(n, seed, center, spread):
    rng = np.random.default_rng(seed)
    o = center + rng.uniform(-spread, spread, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rng.random(n) < 0.2, 0.0, 1e30)  # a fifth of the lanes dead
    return [torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (o, d, t_max)]


def _replayed(fn, inputs, new_inputs):
    """fn(*inputs) recorded through render's seam, the inputs then
    overwritten with new_inputs and the graph replayed → its outputs."""
    replay, outs = render._recorder(torch.device("cuda"))(lambda: fn(*inputs))
    for x, new in zip(inputs, new_inputs):
        x.copy_(new)
    replay()
    torch.cuda.synchronize()
    return outs


def test_one_kernel_launch_records_and_replays(card):
    scene = compile_scene_file(REPO / "scenes" / "mesh10k.pbrt")
    tables = K.DeviceTables(plan_tri_kernel(scene.tris), "cuda")
    center = np.nanmean(tables.slab_aabb.cpu().numpy()[:, :3], axis=0)
    first, second = _rays(4096, 1, center, 2.0), _rays(4096, 2, center, 2.0)
    tables.closest(*first)  # eager: the library loads, the kernel is in place
    t_ref, row_ref = tables.closest(*second)
    t, row = _replayed(tables.closest, [x.clone() for x in first], second)
    assert torch.equal(t.view(torch.int32), t_ref.view(torch.int32))
    assert torch.equal(row, row_ref) and (row >= 0).any()

    bvh = device_bvh(build_flat_bvh(scene), scene.tris, scene.spheres, "cuda")
    bvh_closest(bvh, *first)
    t_ref, ref_ref = bvh_closest(bvh, *second)
    t, ref = _replayed(lambda *r: bvh_closest(bvh, *r), [x.clone() for x in first], second)
    assert torch.equal(t.view(torch.int32), t_ref.view(torch.int32))
    assert torch.equal(ref, ref_ref) and (ref >= 0).any()


@pytest.mark.parametrize("name,intersector,walk", [
    ("cornell_tex", "kernel", ("tri_closest_small", "tri_any_small")),
    ("mesh10k", "kernel", ("tri_closest", "tri_any")),
    ("mesh10k", "bvh", ("bvh_closest", "bvh_any")),
])
def test_replayed_passes_are_the_eager_loop(card, name, intersector, walk):
    scene = compile_scene_file(REPO / "scenes" / f"{name}.pbrt", overrides=OVERRIDES)
    plan = render.plan_render(scene, device="cuda", chunk_pixels=CHUNK, intersector=intersector)
    passes = []
    for graph in (False, True, True):
        K.reset_launches()
        RAY_SORTS["traversals"] = 0
        img, segments = render.render_plan(plan, show_progress=False, count_rays=True,
                                           graph=graph)
        torch.cuda.synchronize()
        passes.append((img, segments, dict(K.LAUNCHES), RAY_SORTS["traversals"]))
    (eager, seg_e, launches_e, sorts_e) = passes[0]
    assert np.isfinite(eager).all() and all(launches_e[k] > 0 for k in walk)
    assert sorted(plan.programs.programs) == [("box", 96), ("box", CHUNK)]
    assert plan.programs.replays == 4 + 5
    for img, segments, launches, sorts in passes[1:]:
        assert np.array_equal(_bits(img), _bits(eager))
        assert (segments, launches, sorts) == (seg_e, launches_e, sorts_e)


def test_a_host_sync_in_the_chunk_raises(card, monkeypatch):
    scene = compile_scene_file(REPO / "scenes" / "cornell_tex.pbrt", overrides=OVERRIDES)
    plan = render.plan_render(scene, device="cuda", chunk_pixels=CHUNK)
    eager = render.render_plan(plan, show_progress=False, graph=False)
    real = render._render_chunk

    def syncing(plan, params, po, px):
        means, bad, seg = real(plan, params, po, px)
        if int(seg.item()) < 0:  # a read back to the host
            raise AssertionError("negative segments")
        return means, bad, seg

    monkeypatch.setattr(render, "_render_chunk", syncing)
    out = []
    with pytest.raises(RuntimeError):
        out.append(render.render_plan(plan, show_progress=False))
    assert out == [] and plan.programs.warm and not plan.programs.programs
    monkeypatch.setattr(render, "_render_chunk", real)
    torch.cuda.synchronize()
    assert np.array_equal(_bits(render.render_plan(plan, show_progress=False, graph=False)),
                          _bits(eager))
