"""The tent-filter splat of the PyTorch port (ops/film.py: filter_splat,
triangle_taps, normalize_splat; render._render_chunk_splat and the
triangle branch of render_plan), mirroring tests/test_film_filter.py and
held against the JAX package on the same inputs.

Tolerances:
  - filter_splat against JAX on the same seeded inputs: film and weight
    sums allclose(rtol=1e-5, atol=1e-6) (XLA's scatter adds each pixel's
    taps one by one, the port reduces each pixel's run in a fixed tree), the
    backward equal to rtol 1e-6 (one gather and one product on both sides);
  - triangle_taps: ids equal exactly, weights and radiance to rtol 1e-6;
  - the triangle-filter render of SCENE_T against JAX's render_scene:
    tests/test_torch_render.py's image tolerance (allclose(1e-4, 1e-4) with
    at most 1% outliers, the sum within 1e-3);
  - the mirrored tests keep their own (finite differences rtol 1e-2 on the
    VJP, 2e-2 on the render's light_L gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curry_pbrt_tpu.ops import film as JF
from curry_pbrt_tpu.render import render_scene as jax_render
from curry_pbrt_tpu.sceneio.compiler import compile_scene_string as jax_compile_string
from curry_pbrt_tpu_torch.interop import params_from_numpy
from curry_pbrt_tpu_torch.ops import film as F
from curry_pbrt_tpu_torch.render import _render_chunk_splat, pixel_arrays, plan_render, render_scene
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_string
from tests.test_film_filter import SCENE_T
from tests.test_torch_grad import leaf_copy, one_torch_thread  # noqa: F401
from tests.test_torch_render import _assert_image_close


def _scene(filt=None, compile_fn=compile_scene_string, **ov):
    f = f'\n  "string filter" ["{filt}"]' if filt else ""
    return compile_fn(SCENE_T.format(filt=f), overrides={"clip": False, **ov})


def _render(scene, **kw):
    return render_scene(scene, device="cpu", show_progress=False, **kw)


# ---------------------------------------------------------------------------
# unit: filter_splat forward and backward, triangle_taps


class TestFilterSplat:
    def test_forward_matches_numpy_scatter(self):
        rng = np.random.default_rng(0)
        M, P = 64, 16
        rad = rng.random((M, 3)).astype(np.float32)
        ids = rng.integers(0, P, (M,)).astype(np.int32)
        w = rng.random((M,)).astype(np.float32)
        film, wsum = F.filter_splat(torch.from_numpy(rad), torch.from_numpy(ids),
                                    torch.from_numpy(w), P)
        ref_f = np.zeros((P, 3), np.float32)
        ref_w = np.zeros((P,), np.float32)
        for i in range(M):
            ref_f[ids[i]] += rad[i] * w[i]
            ref_w[ids[i]] += w[i]
        np.testing.assert_allclose(film.numpy(), ref_f, rtol=1e-5)
        np.testing.assert_allclose(wsum.numpy(), ref_w, rtol=1e-5)

    def test_vjp_matches_finite_difference(self):
        rng = np.random.default_rng(1)
        M, P = 32, 8
        rad = torch.as_tensor(rng.random((M, 3)), dtype=torch.float32)
        ids = torch.as_tensor(rng.integers(0, P, (M,)), dtype=torch.int32)
        w = torch.as_tensor(rng.random((M,)), dtype=torch.float32)
        g_out = torch.as_tensor(rng.random((P, 3)), dtype=torch.float32)

        def loss(r):
            film, wsum = F.filter_splat(r, ids, w, P)
            return torch.sum(film * g_out) + 0.0 * torch.sum(wsum)

        r = rad.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(r), r)
        eps = 1e-3
        for i, c in ((3, 0), (17, 2), (31, 1)):
            dr = torch.zeros((M, 3))
            dr[i, c] = eps
            fd = (float(loss(rad + dr)) - float(loss(rad - dr))) / (2 * eps)
            np.testing.assert_allclose(float(g[i, c]), fd, rtol=1e-2, atol=1e-4)

    def test_triangle_taps_weights(self):
        # one sample at (3.25, 5.75) on an 8x8 film: bilinear weights
        xy = torch.tensor([[3.25, 5.75]])
        _r4, ids, w = F.triangle_taps(xy, torch.ones((1, 3)), 8, 8)
        got = {int(i): float(x) for i, x in zip(ids, w)}
        exp = {5 * 8 + 3: 0.75 * 0.25, 5 * 8 + 4: 0.25 * 0.25,
               6 * 8 + 3: 0.75 * 0.75, 6 * 8 + 4: 0.25 * 0.75}
        for pid, wexp in exp.items():
            np.testing.assert_allclose(got[pid], wexp, rtol=1e-5)
        np.testing.assert_allclose(float(w.sum()), 1.0, rtol=1e-5)

    def test_taps_off_film_and_nan_dropped(self):
        xy = torch.tensor([[-0.4, 0.0], [3.0, 3.0]])
        rad = torch.tensor([[1.0, 1, 1], [np.nan, 1, 1]])
        _r4, ids, w = F.triangle_taps(xy, rad, 8, 8)
        w = w.numpy().reshape(4, 2)
        # sample 0: the x=-1 taps are off-film (weight 0); x=0 taps live
        np.testing.assert_allclose(w[:, 0].sum(), 0.6, rtol=1e-5)
        # the NaN sample contributes nothing anywhere
        assert w[:, 1].sum() == 0.0
        assert (ids.numpy() >= 0).all() and (ids.numpy() < 64).all()  # clipped onto the film

    def test_splat_is_deterministic_and_order_free(self):
        """Two splats of one input are bit-equal; pixels no tap reaches stay
        0."""
        rng = np.random.default_rng(4)
        M, P = 4096, 37
        rad = torch.as_tensor(rng.random((M, 3)), dtype=torch.float32)
        ids = torch.as_tensor(rng.integers(3, P - 5, (M,)), dtype=torch.int32)
        w = torch.as_tensor(rng.random((M,)), dtype=torch.float32)
        a = F.filter_splat(rad, ids, w, P)
        b = F.filter_splat(rad, ids, w, P)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert float(a[1][:3].abs().sum()) == 0.0 and float(a[1][P - 5:].abs().sum()) == 0.0


class TestAgainstJax:
    def test_filter_splat_forward_and_vjp_match_jax(self):
        rng = np.random.default_rng(7)
        M, P = 5000, 300
        rad = rng.random((M, 3)).astype(np.float32) * 4.0
        ids = rng.integers(0, P, (M,)).astype(np.int32)
        w = rng.random((M,)).astype(np.float32)
        g_out = rng.normal(size=(P, 3)).astype(np.float32)

        jfilm, jw = JF.filter_splat(jnp.asarray(rad), jnp.asarray(ids), jnp.asarray(w), P)
        jg = jax.grad(lambda r: jnp.sum(JF.filter_splat(r, jnp.asarray(ids), jnp.asarray(w),
                                                        P)[0] * g_out))(jnp.asarray(rad))
        r = torch.from_numpy(rad).requires_grad_(True)
        film, wsum = F.filter_splat(r, torch.from_numpy(ids), torch.from_numpy(w), P)
        (g,) = torch.autograd.grad(torch.sum(film * torch.from_numpy(g_out)), r)
        np.testing.assert_allclose(film.detach().numpy(), np.asarray(jfilm), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(wsum.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6)

    def test_triangle_taps_match_jax(self):
        rng = np.random.default_rng(8)
        M, xres, yres = 2000, 24, 16
        xy = np.stack([rng.uniform(-1.5, xres + 0.5, M), rng.uniform(-1.5, yres + 0.5, M)],
                      -1).astype(np.float32)
        rad = rng.random((M, 3)).astype(np.float32)
        rad[::97, 1] = np.nan
        jr, ji, jw = JF.triangle_taps(jnp.asarray(xy), jnp.asarray(rad), xres, yres)
        r, i, w = F.triangle_taps(torch.from_numpy(xy), torch.from_numpy(rad), xres, yres)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=0)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6, atol=0)

    def test_triangle_render_matches_jax(self):
        js = _scene("triangle", compile_fn=jax_compile_string)
        ps = _scene("triangle")
        ref = jax_render(js, show_progress=False)
        params = params_from_numpy(jax.tree_util.tree_map(np.asarray, js.init_params), "cpu")
        img = _render(ps, params=params)
        _assert_image_close(img, ref)


# ---------------------------------------------------------------------------
# integration: Film "filter" plumbing + forward + gradients


class TestTriangleFilterRender:
    def test_parse_and_default(self):
        assert _scene().settings.filter == "box"
        assert _scene("triangle").settings.filter == "triangle"
        with pytest.raises(ValueError, match="unsupported film filter"):
            _scene("gaussian")

    def test_forward_close_to_box_and_deterministic(self):
        box = _render(_scene())
        tri = _render(_scene("triangle"))
        tri2 = _render(_scene("triangle"))
        np.testing.assert_array_equal(tri, tri2)
        assert not np.isnan(tri).any()
        # tent filtering preserves energy on smooth content and blurs edges
        np.testing.assert_allclose(tri.mean(), box.mean(), rtol=0.03)
        assert np.abs(tri - box).max() < 0.5
        # it must actually DO something (not silently fall back to box)
        assert np.abs(tri - box).max() > 1e-4

    def test_chunked_splat_matches_single_chunk(self):
        """Footprints crossing chunk edges accumulate: a 4-chunk render
        (and a 3-chunk one with a short last chunk) equals the 1-chunk
        render (same samples, same taps, only the grouping differs)."""
        one = _render(_scene("triangle"), chunk_pixels=256)
        four = _render(_scene("triangle"), chunk_pixels=64)
        three = _render(_scene("triangle"), chunk_pixels=100)
        np.testing.assert_allclose(four, one, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(three, one, rtol=1e-5, atol=1e-6)

    def test_gradient_through_splat_matches_fd(self):
        """The autograd gradient of a filtered-film loss w.r.t. emission L
        against central finite differences: the splat's backward end to
        end (BASELINE config-4 metric through the non-box film)."""
        scene = _scene("triangle")
        plan = plan_render(scene, device="cpu", chunk_pixels=256)
        po, px = pixel_arrays(plan)
        n_pixels = po.shape[0]

        def loss(params):
            film, wsum, _, _ = _render_chunk_splat(plan, params, po, px, n_pixels)
            return torch.sum(F.normalize_splat(film, wsum))

        params = leaf_copy(scene.init_params)
        params["light_L"].requires_grad_(True)
        (g_L,) = torch.autograd.grad(loss(params), params["light_L"])
        assert g_L.shape[0] == scene.n_lights and torch.isfinite(g_L).all()
        eps = 1e-3

        def perturbed(row, ch, sign):
            arr = params["light_L"].detach().clone()
            arr[row, ch] += sign * eps
            return dict(params, light_L=arr)

        with torch.no_grad():
            for row in range(g_L.shape[0]):
                for ch in range(3):
                    fd = (float(loss(perturbed(row, ch, +1)))
                          - float(loss(perturbed(row, ch, -1)))) / (2 * eps)
                    assert fd != 0.0
                    np.testing.assert_allclose(float(g_L[row, ch]), fd, rtol=2e-2)


def test_cli_filter_and_integrator_overrides(tmp_path):
    """--filter and --integrator reach the render: the tent film differs
    from the box film, direct lighting from the path integrator."""
    from pathlib import Path

    from curry_pbrt_tpu_torch.cli import main
    from curry_pbrt_tpu_torch.utils.imageio import read_png

    scene = str(Path(__file__).resolve().parents[1] / "scenes" / "cornell.pbrt")
    base = ["--device", "cpu", "--res", "12", "12", "--spp", "2", "--max-depth", "2", "--quiet"]
    imgs = {}
    for name, extra in (("box", []), ("tent", ["--filter", "triangle"]),
                        ("direct", ["--integrator", "directlighting"])):
        out = tmp_path / f"{name}.png"
        main([scene, "-o", str(out)] + base + extra)
        imgs[name] = read_png(out).astype(np.int32)
        assert imgs[name].shape == (12, 12, 3) and imgs[name].max() > 0
    assert np.abs(imgs["tent"] - imgs["box"]).max() > 0
    assert np.abs(imgs["direct"] - imgs["box"]).max() > 0
