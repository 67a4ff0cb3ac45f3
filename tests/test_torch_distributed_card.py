"""The sharded render and train step (curry_pbrt_tpu_torch/parallel/) on the
card, on cornell_tex at 64², 16 spp, depth 3 (render chunks of 1,000
pixels, so that a slab is rendered in pieces). Imports nothing of JAX, so
that it runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_distributed_card.py -q

Tolerance: none. At world size 1 over NCCL the sharded film is
render_plan's, and the sharded step's texel gradient and loss are
make_train_step's, bit for bit (an all-reduce of one rank is a copy). Two
rank processes sharing the card over gloo (NCCL refuses two ranks on one
card) both hold render_plan's image, bit for bit: each ray's samples
depend only on its pixel, and the gloo film merge adds zeros (exact but
for the sign of a zero, which no pixel of this scene has). Without a card
each test skips (marked cuda).
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from curry_pbrt_tpu_torch.interop import params_from_numpy
from curry_pbrt_tpu_torch.ops.kernels import build
from curry_pbrt_tpu_torch.parallel.mesh import (
    make_mesh,
    make_sharded_train_step,
    make_train_step,
    render_chunk_sharded,
)
from curry_pbrt_tpu_torch.parallel.multihost import run_ranks
from curry_pbrt_tpu_torch.render import pixel_arrays, plan_render, render_plan
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file

REPO = Path(__file__).resolve().parents[1]
SCENE = REPO / "scenes" / "cornell_tex.pbrt"
OVERRIDES = {"resolution": (64, 64), "spp": 16, "max_depth": 3}
CHUNK = 1000

RANK = """
import json, sys
import numpy as np
import torch
from curry_pbrt_tpu_torch.ops.kernels import intersect_kernel as K
from curry_pbrt_tpu_torch.parallel.multihost import render_distributed
rank, init, out, scene = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
img = render_distributed(scene, overrides={overrides!r}, coordinator=init, num_processes=2,
                         process_id=rank, output=out + ".png", device="cuda", backend="gloo")
np.save(f"{{out}}_{{rank}}.npy", img)
torch.distributed.destroy_process_group()  # a gloo group left to the exit can abort it
print(json.dumps({{"rank": rank, "launches": dict(K.LAUNCHES)}}))
""".format(overrides=OVERRIDES)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the traversal kernels have no CPU mode")


@pytest.fixture
def nccl_world_one(card, tmp_path):
    """A one-rank NCCL group for the test, torn down after it."""
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)
    try:
        yield make_mesh(1, device="cuda")
    finally:
        dist.destroy_process_group()


def _bits(img):
    return np.ascontiguousarray(img, dtype=np.float32).view(np.uint32)


def _plan():
    scene = compile_scene_file(SCENE, overrides=OVERRIDES)
    return scene, plan_render(scene, device="cuda", chunk_pixels=CHUNK)


@pytest.mark.cuda
def test_world_one_nccl_render_is_render_plan(nccl_world_one):
    scene, plan = _plan()
    assert dist.get_backend(nccl_world_one.group) == "nccl"
    film = render_chunk_sharded(plan, nccl_world_one, scene.init_params, *pixel_arrays(plan))
    ref = render_plan(plan, show_progress=False)
    assert film.device.type == "cuda"
    assert np.array_equal(_bits(film.cpu().numpy().reshape(ref.shape)), _bits(ref))


@pytest.mark.cuda
def test_world_one_sharded_step_is_the_train_step(nccl_world_one):
    scene, plan = _plan()
    po, px = pixel_arrays(plan)
    target = torch.as_tensor(render_plan(plan, show_progress=False).reshape(-1, 3), device="cuda")
    got = []
    for make in (make_train_step, lambda p, o: make_sharded_train_step(p, nccl_world_one, o)):
        params = params_from_numpy(scene.init_params, "cuda")
        key = next(iter(params["textures"]))
        tex = params["textures"][key] = torch.full_like(params["textures"][key], 0.5)
        tex.requires_grad_(True)
        loss = make(plan, torch.optim.Adam([tex], lr=0.05))(params, target, po, px)
        got.append((float(loss), tex.grad.clone(), tex.detach().clone()))
    (l0, g0, t0), (l1, g1, t1) = got
    assert l0 == l1 and l0 > 0
    assert torch.equal(g0, g1) and float(g0.abs().sum()) > 0
    assert torch.equal(t0, t1)


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card(card, tmp_path):
    build.build()  # once, before the ranks start
    init, stem = f"file://{tmp_path / 'store'}", str(tmp_path / "img")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    results = run_ranks(lambda r: [sys.executable, "-c", RANK, str(r), init, stem, str(SCENE)],
                        2, timeout=600, env=env)
    for r, (rc, out, err) in enumerate(results):
        assert rc == 0, f"rank {r}:\n{out}\n{err[-3000:]}"
        launches = json.loads(out.strip().splitlines()[-1])["launches"]
        assert launches["tri_closest_small"] > 0 and launches["tri_any_small"] > 0
    imgs = [np.load(f"{stem}_{r}.npy") for r in range(2)]
    scene, plan = _plan()
    ref = render_plan(plan, show_progress=False)
    assert np.array_equal(_bits(imgs[0]), _bits(imgs[1]))
    assert np.array_equal(_bits(imgs[0]), _bits(ref))
