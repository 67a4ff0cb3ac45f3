"""Differentiable rendering in the PyTorch port: pixel gradients through
render._render_chunk (the autograd graph stops at the traversal; material,
light and texture parameters are the leaves), mirroring tests/test_grad.py
and held against jax.grad of the same loss, and the train step of
curry_pbrt_tpu_torch/parallel/mesh.py.

Tolerances:
  - the mirrored tests keep their own: finite differences rtol 2e-2; Kd
    recovery atol 0.01 with the final MSE below 1e-6; brute against kernel
    gradients rtol 1e-4, atol 1e-7;
  - the port's Kd and light_L gradients against jax.grad of the same loss
    on the same parameters: rtol 1e-3, atol 1e-6 of the largest entry (the
    image tolerance of tests/test_torch_render.py, carried through one
    backward; XLA's CPU FMAs and the port's separately rounded ops differ by
    a few ULPs per op);
  - the train step's sub-chunked gradient against one-graph autograd over
    the same pixels: rtol 1e-5, atol 1e-8 (the same per-pixel terms, summed
    in another order);
  - no NaN or inf in any gradient, on a scene with glass, a mirror, a
    sphere, an image texture and a two-member material family.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curry_pbrt_tpu.render import _render_chunk as jax_render_chunk
from curry_pbrt_tpu.render import plan_render as jax_plan
from curry_pbrt_tpu.sceneio.compiler import compile_scene_file as jax_compile
from curry_pbrt_tpu.sceneio.compiler import compile_scene_string as jax_compile_string
from curry_pbrt_tpu_torch.interop import params_from_numpy
from curry_pbrt_tpu_torch.parallel.mesh import (
    backward_over_pixels,
    make_train_step,
    mse_pixel_loss,
)
from curry_pbrt_tpu_torch.render import _render_chunk, pixel_arrays, plan_render
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file, compile_scene_string
from tests.test_grad import SCENE

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tests: the tier-1 run puts
    several xdist workers on the same cores, and their per-op thread pools
    then wait on one another (a 0.7 s render took 100 s that way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leaf_copy(tree):
    """A copy of a params tree whose tensors are new leaves."""
    if isinstance(tree, dict):
        return {k: leaf_copy(v) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree)).clone()


def grads(plan, params, po, px, leaves):
    """d sum(_render_chunk) / d each of `leaves` (tensors of `params`)."""
    for leaf in leaves:
        leaf.requires_grad_(True)
    img, _, _ = _render_chunk(plan, params, po, px)
    return torch.autograd.grad(img.sum(), leaves)


@pytest.fixture(scope="module")
def setup():
    scene = compile_scene_string(SCENE, overrides={"clip": False})
    plan = plan_render(scene, device="cpu", chunk_pixels=64)
    po, px = pixel_arrays(plan)
    return scene, plan, po, px


def loss_value(plan, params, po, px):
    with torch.no_grad():
        return float(_render_chunk(plan, params, po, px)[0].sum())


def fd_grad(plan, params, po, px, path, idx, eps=1e-3):
    """Central finite difference of one scalar leaf entry."""

    def perturbed(sign):
        p = leaf_copy(params)
        leaf = p
        for k in path[:-1]:
            leaf = leaf[k]
        leaf[path[-1]].reshape(-1)[idx] += sign * eps
        return p

    return (loss_value(plan, perturbed(+1), po, px)
            - loss_value(plan, perturbed(-1), po, px)) / (2 * eps)


class TestGradients:
    def test_albedo_gradient_matches_fd(self, setup):
        scene, plan, po, px = setup
        params = leaf_copy(scene.init_params)
        mat_key = next(iter(params["materials"]))
        (g_kd,) = grads(plan, params, po, px, [params["materials"][mat_key]["Kd"]])
        assert g_kd.shape == (3,)
        for ch in range(3):
            fd = fd_grad(plan, scene.init_params, po, px, ("materials", mat_key, "Kd"), ch)
            assert fd != 0.0
            np.testing.assert_allclose(float(g_kd[ch]), fd, rtol=2e-2)

    def test_emission_gradient_matches_fd(self, setup):
        scene, plan, po, px = setup
        params = leaf_copy(scene.init_params)
        (g_L,) = grads(plan, params, po, px, [params["light_L"]])
        # both area-light triangles share one L row each
        for li in range(g_L.shape[0]):
            fd = fd_grad(plan, scene.init_params, po, px, ("light_L",), 3 * li, eps=1e-2)
            np.testing.assert_allclose(float(g_L[li, 0]), fd, rtol=2e-2)

    def test_emission_gradient_positive(self, setup):
        # more light → more pixels lit: dLoss/dL > 0
        scene, plan, po, px = setup
        params = leaf_copy(scene.init_params)
        (g_L,) = grads(plan, params, po, px, [params["light_L"]])
        assert bool((g_L >= 0).all()) and float(g_L.sum()) > 0


class TestInverseRendering:
    def test_optimize_albedo_recovers_target(self, setup):
        """Render a target with known albedo, re-optimize from a wrong
        initialization through the train step — the albedo converges to
        the target (the config-4 task, scalar version). Only Kd is
        optimized: emission is known in the config-4 task (image ∝ L·Kd
        would make the problem degenerate)."""
        scene, plan, po, px = setup
        with torch.no_grad():
            target = _render_chunk(plan, scene.init_params, po, px)[0]
        params = leaf_copy(scene.init_params)
        mat_key = [k for k, v in params["materials"].items() if "Kd" in v][0]
        kd = params["materials"][mat_key]["Kd"]
        with torch.no_grad():
            kd.copy_(torch.tensor([0.9, 0.1, 0.6]))
        kd.requires_grad_(True)
        step = make_train_step(plan, torch.optim.Adam([kd], lr=0.1))
        for _ in range(250):
            loss = step(params, target, po, px)
        np.testing.assert_allclose(kd.detach().numpy(), [0.5, 0.4, 0.3], atol=0.01)
        assert float(loss) < 1e-6


class TestGradientBackendEquivalence:
    def test_grad_matches_across_intersectors(self, setup):
        """Parameter gradients are the same through the brute oracle and
        the traversal kernels (their plain versions here): both detach the
        ray geometry at the traversal, and a misplaced detach would ship
        silently. The port has no 'bvh' intersector yet (ROADMAP.md item
        13)."""
        scene, _plan, po, px = setup
        out = {}
        for backend in ("brute", "kernel"):
            plan_b = plan_render(scene, device="cpu", intersector=backend, chunk_pixels=64)
            params = leaf_copy(scene.init_params)
            mat_key = next(iter(params["materials"]))
            out[backend] = [g.numpy() for g in grads(
                plan_b, params, po, px, [params["materials"][mat_key]["Kd"], params["light_L"]])]
        for a, b in zip(out["brute"], out["kernel"]):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-7)
        # and they are real gradients, not zeros
        assert np.abs(out["brute"][0]).sum() > 0
        assert np.abs(out["brute"][1]).sum() > 0


CORNELL_SMALL = {"resolution": (8, 8), "spp": 2, "max_depth": 2}


@pytest.mark.parametrize("name", ["plane", "cornell"])
def test_grads_match_jax(name):
    """Every Kd leaf and light_L: the port's autograd against jax.grad of
    sum(_render_chunk) on the same parameters — SCENE, and cornell.pbrt at
    8², 2 spp, depth 2 (glass, a mirror, the red and green walls as one
    two-member matte family: their Kd reach the image through its
    stacking)."""
    if name == "plane":
        js = jax_compile_string(SCENE, overrides={"clip": False})
        ps = compile_scene_string(SCENE, overrides={"clip": False})
    else:
        js = jax_compile(REPO / "scenes" / "cornell.pbrt", overrides=CORNELL_SMALL)
        ps = compile_scene_file(REPO / "scenes" / "cornell.pbrt", overrides=CORNELL_SMALL)
    plan = plan_render(ps, device="cpu")
    po, px = pixel_arrays(plan)
    jplan = jax_plan(js, chunk_pixels=po.shape[0])
    jpo = jnp.asarray(jplan.pixel_offsets.reshape(-1))
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jax_render_chunk(jplan, p, jpo, jnp.asarray(
        px.numpy())))))(js.init_params)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, js.init_params), "cpu")
    keys = [k for k, v in params["materials"].items() if "Kd" in v]
    if name == "cornell":
        assert max(len(f.members) for f in plan.ctx.families) >= 2
    leaves = [params["materials"][k]["Kd"] for k in keys] + [params["light_L"]]
    got = grads(plan, params, po, px, leaves)
    want = [np.asarray(jg["materials"][k]["Kd"]) for k in keys] + [np.asarray(jg["light_L"])]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=1e-6 * np.abs(w).max())
    assert np.abs(want[-1]).max() > 0


def test_sub_chunked_gradient_matches_one_graph():
    """The train step's backward per sub-chunk (plans of 16 and of 24 pixels
    a chunk, the last one short, over cornell.pbrt's 64 pixels) gives the
    one-graph gradient and loss — through the red and green walls' shared
    member stacking, which each chunk's graph restacks for itself."""
    ps = compile_scene_file(REPO / "scenes" / "cornell.pbrt", overrides=CORNELL_SMALL)
    out = {}
    for sub in (64, 16, 24):
        plan = plan_render(ps, device="cpu", chunk_pixels=sub)
        po, px = pixel_arrays(plan)
        if sub == 64:
            assert max(len(f.members) for f in plan.ctx.families) >= 2
            with torch.no_grad():
                target = _render_chunk(plan, ps.init_params, po, px)[0] * 0.8
        params = leaf_copy(ps.init_params)
        leaves = [params["light_L"]] + [v["Kd"] for v in params["materials"].values() if "Kd" in v]
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss = backward_over_pixels(plan, params, po, px, mse_pixel_loss(target))
        out[sub] = (float(loss), [leaf.grad.numpy() for leaf in leaves])
    for sub in (16, 24):
        np.testing.assert_allclose(out[sub][0], out[64][0], rtol=1e-5)
        for a, b in zip(out[sub][1], out[64][1]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-8)
    assert all(np.abs(b).max() > 0 for b in out[64][1])


def test_gradients_finite_and_geometry_detached():
    """cornell_tex at 16², 4 spp, depth 3 (a glass sphere, a mirror, the
    image texture, two lights, a two-member matte family): every leaf
    requires grad, every
    gradient is finite — safe_sqrt's and normalize's double where hold
    under backward — and the hit attributes rebuilt after the traversal
    carry no graph."""
    ps = compile_scene_file(REPO / "scenes" / "cornell_tex.pbrt",
                            overrides={"resolution": (16, 16), "spp": 4, "max_depth": 3})
    plan = plan_render(ps, device="cpu")
    po, px = pixel_arrays(plan)
    params = leaf_copy(ps.init_params)
    leaves = [params["light_L"]] + list(params["textures"].values()) + [
        v for slots in params["materials"].values() for v in slots.values()]
    for leaf in leaves:
        leaf.requires_grad_(True)
    img, _, _ = _render_chunk(plan, params, po, px)
    # unread slots (matte's sigma without Oren-Nayar) get no gradient
    got = torch.autograd.grad(img.sum(), leaves, allow_unused=True)
    assert sum(g is not None for g in got) > 5
    for g in got:
        assert g is None or torch.isfinite(g).all()
    tex_grad = got[1]
    assert (tex_grad.abs().sum(-1) > 0).sum() > 4  # visible texels receive gradient
    assert float(got[0].abs().sum()) > 0

    o = torch.tensor([[278.0, 273.0, -800.0]]).repeat(4, 1).requires_grad_(True)
    d = torch.tensor([[0.0, 0.0, 1.0], [0.1, 0.0, 1.0], [0.0, 0.1, 1.0], [0.0, -0.2, 1.0]])
    d = (d / d.norm(dim=-1, keepdim=True)).requires_grad_(True)
    hit = plan.ctx.intersect(o * 1.0, d * 1.0, torch.full((4,), 1e30))
    assert bool(hit.valid.all())
    for attr in (hit.p, hit.n, hit.uv, hit.p_error):
        assert not attr.requires_grad
