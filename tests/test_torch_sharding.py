"""Ray sharding in the PyTorch port (curry_pbrt_tpu_torch/parallel/mesh.py)
over gloo ranks on the CPU, mirroring tests/test_sharding.py: the image
does not depend on the world size, and the gradients are averaged over the
ranks.

Every world size (1, 2 and 4 ranks) runs once, as rank processes of one
gloo group (parallel/multihost.run_ranks; init through a file store under
the test's tmp_path, one intra-op thread a rank), on AREA_LIGHT_VISIBLE at
2 spp, its 256 pixels as one chunk (chunk_pixels 256, the JAX test's plan);
each rank saves what it computed, and the tests compare:

  - every rank of a world holds the same film (equal);
  - the sharded film against the port's unsharded render._render_chunk,
    and against the JAX package's make_sharded_render(plan, make_mesh(8)),
    also in pieces of 40 pixels (a slab rendered in render chunks) and over
    250 pixels (padded to the world size): rtol 1e-5, atol 1e-6, the JAX
    test's tolerance (tests/test_sharding.py:43, :52) — torch's vectorised
    CPU kernels round a loop's scalar tail differently, so slabs of other
    lengths may move a lane by an ULP; on the card the port is held to
    bit-equality (tests/test_torch_distributed_card.py, chip_smoke.py);
  - the light_L gradient of the image MSE through make_sharded_train_step
    against the port's unsharded backward and against jax.grad of the JAX
    unsharded loss (tests/test_sharding.py:78-106): rtol 1e-4, atol 1e-7,
    that test's tolerance; the averaged loss against the unsharded MSE,
    rtol 1e-5;
  - one Adam step toward a black target moves light_L on every rank alike.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curry_pbrt_tpu.parallel.mesh import make_mesh as jax_make_mesh
from curry_pbrt_tpu.parallel.mesh import make_sharded_render as jax_sharded_render
from curry_pbrt_tpu.render import _render_chunk as jax_render_chunk
from curry_pbrt_tpu.render import plan_render as jax_plan
from curry_pbrt_tpu.sceneio.compiler import compile_scene_string as jax_compile
from curry_pbrt_tpu_torch.interop import params_from_numpy
from curry_pbrt_tpu_torch.parallel.mesh import (
    RayMesh,
    backward_over_pixels,
    make_mesh,
    make_sharded_train_step,
    mse_pixel_loss,
    render_chunk_sharded,
)
from curry_pbrt_tpu_torch.parallel.multihost import run_ranks
from curry_pbrt_tpu_torch.render import _render_chunk, pixel_arrays, plan_render
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_string
from tests.test_render_analytic import AREA_LIGHT_VISIBLE

REPO = Path(__file__).resolve().parents[1]
WORLDS = (1, 2, 4)
IMG_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-7)

# One rank: the sharded render (whole chunk, 40-pixel pieces, 250 padded
# pixels), the light_L gradient of the MSE against 0.5 through the sharded
# step (SGD at lr 0 keeps the state), and one Adam step toward black.
RANK = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from curry_pbrt_tpu_torch.interop import params_from_numpy
from curry_pbrt_tpu_torch.parallel.mesh import make_mesh, make_sharded_render, make_sharded_train_step
from curry_pbrt_tpu_torch.render import pixel_arrays, plan_render
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_string
rank, world, init, out, scene_text = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
mesh = make_mesh(world, device="cpu")
scene = compile_scene_string(scene_text, overrides={"spp": 2})
plan = plan_render(scene, device="cpu", chunk_pixels=256)
po, px = pixel_arrays(plan)
img = make_sharded_render(plan, mesh)(scene.init_params, po, px)
pieces = make_sharded_render(plan_render(scene, device="cpu", chunk_pixels=40), mesh)(
    scene.init_params, po, px)
padded = make_sharded_render(plan, mesh)(scene.init_params, po[:250], px[:250])
params = params_from_numpy(scene.init_params, "cpu")
light = params["light_L"] = params["light_L"].clone().requires_grad_(True)
step = make_sharded_train_step(plan, mesh, torch.optim.SGD([light], lr=0.0))
loss = step(params, torch.full((256, 3), 0.5), po, px)
grad = light.grad.clone()
moved = params["light_L"] = params["light_L"].detach().clone().requires_grad_(True)
step = make_sharded_train_step(plan, mesh, torch.optim.Adam([moved], lr=1e-2))
loss_adam = step(params, torch.zeros((256, 3)), po, px)
np.savez(f"{out}_{rank}.npz", img=img.numpy(), pieces=pieces.numpy(), padded=padded.numpy(),
         grad=grad.numpy(), loss=loss.item(), light_after=moved.detach().numpy(),
         loss_adam=loss_adam.item())
dist.destroy_process_group()
print("RANK_OK", rank)
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: six xdist workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world size: [each rank's saved arrays]} for 1, 2 and 4 gloo ranks,
    the three groups at once."""
    tmp = tmp_path_factory.mktemp("sharding")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")

    def world_run(world):
        init, stem = f"file://{tmp / f'store_{world}'}", str(tmp / f"world{world}")
        results = run_ranks(lambda r: [sys.executable, "-c", RANK, str(r), str(world), init, stem,
                                       AREA_LIGHT_VISIBLE], world, timeout=240, env=env)
        for r, (rc, stdout, stderr) in enumerate(results):
            assert rc == 0 and f"RANK_OK {r}" in stdout, f"rank {r} of {world}:\n{stderr[-3000:]}"
        return [dict(np.load(f"{stem}_{r}.npz")) for r in range(world)]

    with ThreadPoolExecutor(len(WORLDS)) as pool:
        return dict(zip(WORLDS, pool.map(world_run, WORLDS)))


@pytest.fixture(scope="module")
def unsharded():
    """The port's unsharded film, light_L gradient and MSE on the same chunk."""
    scene = compile_scene_string(AREA_LIGHT_VISIBLE, overrides={"spp": 2})
    plan = plan_render(scene, device="cpu", chunk_pixels=256)
    po, px = pixel_arrays(plan)
    params = params_from_numpy(scene.init_params, "cpu")
    with torch.no_grad():
        img = _render_chunk(plan, params, po, px)[0].numpy()
    light = params["light_L"] = params["light_L"].clone().requires_grad_(True)
    loss = backward_over_pixels(plan, params, po, px, mse_pixel_loss(torch.full((256, 3), 0.5)))
    return {"img": img, "grad": light.grad.numpy(), "loss": float(loss), "plan": plan,
            "scene": scene}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's 8-device sharded film and jax.grad of its unsharded
    MSE w.r.t. light_L (tests/test_sharding.py's)."""
    scene = jax_compile(AREA_LIGHT_VISIBLE, overrides={"spp": 2})
    plan = jax_plan(scene, chunk_pixels=256)
    ys, xs = np.mgrid[0:16, 0:16]
    px = jnp.asarray(np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32))
    po = jnp.asarray(plan.pixel_offsets.reshape(-1))
    img = jax_sharded_render(plan, jax_make_mesh(8))(scene.init_params, po, px)
    target = jnp.full((256, 3), 0.5, jnp.float32)

    def loss(p):
        return jnp.mean((jax_render_chunk(plan, p, po, px) - target) ** 2)

    grad = jax.grad(loss)(scene.init_params)["light_L"]
    return {"img": np.asarray(img), "grad": np.asarray(grad)}


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_render_matches_unsharded(ranks, unsharded, world):
    for r in range(1, world):
        for key in ("img", "pieces", "padded"):
            np.testing.assert_array_equal(ranks[world][r][key], ranks[world][0][key])
    got = ranks[world][0]
    assert got["img"].shape == (256, 3) and got["padded"].shape == (250, 3)
    np.testing.assert_allclose(got["img"], unsharded["img"], **IMG_TOL)
    np.testing.assert_allclose(got["pieces"], unsharded["img"], **IMG_TOL)
    np.testing.assert_allclose(got["padded"], unsharded["img"][:250], **IMG_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_render_matches_the_jax_sharded_render(ranks, jax_side, world):
    np.testing.assert_allclose(ranks[world][0]["img"], jax_side["img"], **IMG_TOL)


def test_world_size_invariance(ranks):
    np.testing.assert_allclose(ranks[2][0]["img"], ranks[4][0]["img"], **IMG_TOL)


def test_sharded_train_step_runs_and_reduces(ranks, unsharded):
    """One Adam step toward a black target moves light_L, the same on every
    rank (tests/test_sharding.py::test_train_step_runs_and_reduces)."""
    l0 = np.asarray(unsharded["scene"].init_params["light_L"])
    for world in (2, 4):
        after = [r["light_after"] for r in ranks[world]]
        assert np.isfinite(ranks[world][0]["loss_adam"])
        assert not np.allclose(after[0], l0)
        for a in after[1:]:
            np.testing.assert_array_equal(a, after[0])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_gradient_matches_unsharded(ranks, unsharded, jax_side, world):
    """The averaged light_L gradient and loss of `world` ranks against the
    port's unsharded ones and jax.grad of the JAX unsharded loss."""
    for r in ranks[world]:
        np.testing.assert_array_equal(r["grad"], ranks[world][0]["grad"])
    got = ranks[world][0]
    assert np.abs(unsharded["grad"]).sum() > 0
    np.testing.assert_allclose(got["grad"], unsharded["grad"], **GRAD_TOL)
    np.testing.assert_allclose(got["grad"], jax_side["grad"], **GRAD_TOL)
    np.testing.assert_allclose(got["loss"], unsharded["loss"], rtol=1e-5)


def test_make_mesh_outside_a_group_is_one_rank():
    mesh = make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.world_size, mesh.device.type) == (None, 0, 1, "cpu")
    with pytest.raises(ValueError, match="process group has 1"):
        make_mesh(2, device="cpu")


def test_sharded_paths_refuse_what_they_cannot_split(unsharded):
    """A tent-filter scene does not render sharded, and the sharded step
    takes no pixel count the world size does not divide; both raise before
    any collective (a two-rank mesh without a group)."""
    two = RayMesh(None, 0, 2, torch.device("cpu"))
    tent = compile_scene_string(AREA_LIGHT_VISIBLE, overrides={"spp": 2, "filter": "triangle"})
    plan = plan_render(tent, device="cpu", chunk_pixels=256)
    with pytest.raises(ValueError, match="triangle"):
        render_chunk_sharded(plan, two, tent.init_params, *pixel_arrays(plan))
    plan = unsharded["plan"]
    po, px = pixel_arrays(plan)
    light = torch.ones((1, 3), requires_grad=True)
    step = make_sharded_train_step(plan, two, torch.optim.SGD([light], lr=0.0))
    with pytest.raises(ValueError, match="multiple of the world size"):
        step(unsharded["scene"].init_params, torch.zeros((255, 3)), po[:255], px[:255])
