"""The direct-lighting integrator of the PyTorch port
(models/integrators.direct_light_trace), mirroring
tests/test_direct_light.py and held against the JAX package.

  - the four mirrored tests (mirror and glass scenes: one luminance-weighted
    delta branch per lane, deterministic, unbiased across spp);
  - scenes/spheres.pbrt (directlighting, depth 3 at 32², 4 spp: point,
    spherical area and distant lights on spheres) against
    tests/goldens/spheres.npy, the JAX CPU render of tools/make_goldens.py;
  - the mirror and glass scenes against JAX's chunk render
    (`_render_chunk_stats`, the box film of render_scene) on the same
    parameters, with traced-segment counts equal.

Image tolerance: tests/test_torch_render.py's (allclose(1e-4, 1e-4) with
at most 1% of the values outside, the image sum within 1e-3 relative).
Segment counts are integers and must be equal.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from curry_pbrt_tpu.render import _chunked_pixel_arrays as jax_chunks
from curry_pbrt_tpu.render import _render_chunk_stats as jax_chunk_stats
from curry_pbrt_tpu.render import plan_render as jax_plan
from curry_pbrt_tpu.sceneio.compiler import compile_scene_string as jax_compile_string
from curry_pbrt_tpu_torch.interop import params_from_numpy
from curry_pbrt_tpu_torch.render import plan_render, render_scene
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file, compile_scene_string
from tests.test_direct_light import GLASS_SCENE, MIRROR_SCENE
from tests.test_torch_grad import one_torch_thread  # noqa: F401
from tests.test_torch_render import _assert_image_close

REPO = Path(__file__).resolve().parents[1]


def _render(text, spp, seed=0, **kw):
    scene = compile_scene_string(text % spp, overrides={"clip": False, "seed": seed})
    return render_scene(scene, device="cpu", show_progress=False, **kw)


class TestMirrorBranch:
    def test_mirror_reflects_light(self):
        """Single delta lobe ⇒ the stochastic choice is deterministic
        (p = 1) and must find the emitter through the mirror."""
        img = _render(MIRROR_SCENE, 4)
        assert not np.isnan(img).any()
        assert img.max() > 1.0  # emitter visible via the specular bounce

    def test_deterministic(self):
        a = _render(MIRROR_SCENE, 2)
        b = _render(MIRROR_SCENE, 2)
        np.testing.assert_array_equal(a, b)


class TestGlassStochastic:
    def test_depth4_runs_linear_not_exponential(self):
        """Glass has 2 delta lobes; one batch trace per level, so depth 4
        is four traces, not 2^4."""
        scene = compile_scene_string(GLASS_SCENE % 4, overrides={"clip": False})
        assert plan_render(scene, device="cpu").max_delta_lobes() == 2
        img = render_scene(scene, device="cpu", show_progress=False)
        assert not np.isnan(img).any()
        assert img.mean() > 0.0

    def test_spp_consistency_unbiased(self):
        """Estimator mean stable across sample counts (doubling spp only
        reduces variance)."""
        lo = _render(GLASS_SCENE, 16)
        hi = _render(GLASS_SCENE, 64)
        m_lo, m_hi = float(lo.mean()), float(hi.mean())
        assert abs(m_lo - m_hi) / max(m_hi, 1e-9) < 0.12, (m_lo, m_hi)


def test_spheres_matches_golden():
    ps = compile_scene_file(REPO / "scenes" / "spheres.pbrt",
                            overrides={"resolution": (32, 32), "spp": 4, "max_depth": 3})
    assert ps.settings.integrator == "directlighting"
    img = render_scene(ps, device="cpu", show_progress=False)
    _assert_image_close(img, np.load(REPO / "tests" / "goldens" / "spheres.npy"))


def _jax_render_and_segments(scene):
    """JAX's box image and traced segments from one jitted chunk function."""
    plan = jax_plan(scene)
    po, px, n_pixels = jax_chunks(plan)
    fn = jax.jit(lambda p, a, b: jax_chunk_stats(plan, p, a, b))
    parts = [fn(scene.init_params, jnp.asarray(po[k]), jnp.asarray(px[k]))
             for k in range(po.shape[0])]
    xres, yres = scene.settings.resolution
    img = np.concatenate([np.asarray(m) for m, _ in parts])[:n_pixels].reshape(yres, xres, 3)
    return img, sum(float(s) for _, s in parts)


@pytest.mark.parametrize("text,spp", [(MIRROR_SCENE, 4), (GLASS_SCENE, 8)],
                         ids=["mirror", "glass"])
def test_port_matches_jax(text, spp):
    js = jax_compile_string(text % spp, overrides={"clip": False})
    ps = compile_scene_string(text % spp, overrides={"clip": False})
    ref, ref_segments = _jax_render_and_segments(js)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, js.init_params), "cpu")
    img, segments = render_scene(ps, params=params, device="cpu", show_progress=False,
                                 count_rays=True)
    _assert_image_close(img, ref)
    assert segments == int(ref_segments)
