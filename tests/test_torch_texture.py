"""Image textures in the PyTorch port: scoping, loading, nearest lookup with
the v-flip, and texture-space gradients (BASELINE.json config 4: optimize
an albedo TEXTURE from a target image), mirroring tests/test_texture.py and
held against JAX's texel gradients.

Tolerances:
  - the mirrored tests keep their own (texture recovery: mean texel error
    below 0.05 over the texels the camera sees, final MSE below 1e-4);
  - texel gradients against jax.grad of sum(_render_chunk) on the same
    parameters: the same texels receive gradient, values allclose(rtol=1e-3,
    atol=1e-6 of the largest entry) (tests/test_torch_grad.py's gradient
    tolerance). A texel's gradient sums the lanes that read it — an index
    gather's backward — in another order on each side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curry_pbrt_tpu.render import _render_chunk as jax_render_chunk
from curry_pbrt_tpu.render import plan_render as jax_plan
from curry_pbrt_tpu.sceneio.compiler import compile_scene_file as jax_compile
from curry_pbrt_tpu_torch.interop import params_from_numpy
from curry_pbrt_tpu_torch.parallel.mesh import make_train_step
from curry_pbrt_tpu_torch.render import _render_chunk, pixel_arrays, plan_render, render_scene
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file
from curry_pbrt_tpu_torch.utils.imageio import write_png
from tests.test_torch_grad import grads, leaf_copy, one_torch_thread  # noqa: F401

TEXTURED = """
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "halton" "integer pixelsamples" [4]
Camera "perspective" "float fov" [60]
Integrator "path" "integer maxdepth" [1]
WorldBegin
AttributeBegin
  Translate 0 1 1
  LightSource "point" "rgb I" [8 8 8]
AttributeEnd
Texture "tex" "spectrum" "imagemap" "string filename" ["checker.png"]
Material "matte" "texture Kd" ["tex"]
Shape "trianglemesh" "integer indices" [0 1 2 2 3 0]
  "point P" [-4 -1 0   4 -1 0   4 -1 8   -4 -1 8]
WorldEnd
"""


@pytest.fixture(scope="module")
def textured_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("tex")
    rng = np.random.RandomState(0)
    write_png(d / "checker.png", (rng.rand(8, 8, 3) * 200 + 30).astype(np.uint8))
    (d / "scene.pbrt").write_text(TEXTURED)
    return d / "scene.pbrt"


@pytest.fixture(scope="module")
def textured_scene(textured_path):
    return compile_scene_file(textured_path, overrides={"clip": False})


class TestTextureScoping:
    """The reference scopes texture maps per attribute block
    (scene.rs:51-56): materials bind the texture definition visible in
    THEIR scope at compile time, not the last one globally."""

    @staticmethod
    def _write_tex(path, value_u8):
        write_png(path, np.full((4, 4, 3), value_u8, np.uint8))

    def _scene(self, d):
        self._write_tex(d / "bright.png", 230)
        self._write_tex(d / "dark.png", 25)
        text = """
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Sampler "halton" "integer pixelsamples" [1]
Camera "perspective" "float fov" [60]
Integrator "path" "integer maxdepth" [1]
WorldBegin
AttributeBegin
  Texture "t" "spectrum" "imagemap" "string filename" ["bright.png"]
  Material "matte" "texture Kd" ["t"]
  Shape "trianglemesh" "integer indices" [0 1 2]
    "point P" [-1 -1 2   1 -1 2   0 1 2]
AttributeEnd
AttributeBegin
  Texture "t" "spectrum" "imagemap" "string filename" ["dark.png"]
  Material "matte" "texture Kd" ["t"]
  Shape "trianglemesh" "integer indices" [0 1 2]
    "point P" [-1 -1 3   1 -1 3   0 1 3]
AttributeEnd
WorldEnd
"""
        (d / "scene.pbrt").write_text(text)
        return compile_scene_file(d / "scene.pbrt", overrides={"clip": False})

    def test_sibling_scopes_bind_distinct_files(self, tmp_path):
        scene = self._scene(tmp_path)
        assert len(scene.init_params["textures"]) == 2
        keys = set()
        for mat in scene.materials:
            ref = mat.refs["Kd"]
            assert ref.kind == "texture"
            keys.add(ref.tex)
            assert ref.tex in scene.init_params["textures"]
        assert len(keys) == 2
        bound = {float(np.asarray(scene.init_params["textures"][k]).mean()) for k in keys}
        assert min(bound) < 0.05 and max(bound) > 0.5  # dark and bright

    def test_undefined_texture_raises(self, tmp_path):
        text = """
WorldBegin
Material "matte" "texture Kd" ["nosuch"]
Shape "trianglemesh" "integer indices" [0 1 2] "point P" [0 0 2 1 0 2 0 1 2]
WorldEnd
"""
        (tmp_path / "bad.pbrt").write_text(text)
        with pytest.raises(ValueError, match="undefined texture"):
            compile_scene_file(tmp_path / "bad.pbrt")

    def test_mix_with_textured_amount(self, tmp_path):
        """`mix` whose amount is a texture resolves and renders."""
        self._write_tex(tmp_path / "amt.png", 128)
        text = """
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Sampler "halton" "integer pixelsamples" [2]
Camera "perspective" "float fov" [60]
Integrator "path" "integer maxdepth" [1]
WorldBegin
AttributeBegin
  Translate 0 1 1
  LightSource "point" "rgb I" [8 8 8]
AttributeEnd
Texture "amt" "spectrum" "imagemap" "string filename" ["amt.png"]
MakeNamedMaterial "a" "string type" ["matte"] "rgb Kd" [0.9 0.1 0.1]
MakeNamedMaterial "b" "string type" ["matte"] "rgb Kd" [0.1 0.1 0.9]
Material "mix" "texture amount" ["amt"]
  "string namedmaterial1" ["a"] "string namedmaterial2" ["b"]
Shape "trianglemesh" "integer indices" [0 1 2 2 3 0]
  "point P" [-4 -1 0   4 -1 0   4 -1 8   -4 -1 8]
WorldEnd
"""
        (tmp_path / "mix.pbrt").write_text(text)
        scene = compile_scene_file(tmp_path / "mix.pbrt", overrides={"clip": False})
        amt_ref = next(m for m in scene.materials if m.kind == "mix").refs["amount"]
        assert amt_ref.kind == "texture" and amt_ref.tex in scene.init_params["textures"]
        img = render_scene(scene, device="cpu", show_progress=False)
        assert not np.isnan(img).any()
        assert img.max() > 0


class TestImageTexture:
    def test_texture_loaded_inverse_gamma(self, textured_scene):
        scene = textured_scene
        assert len(scene.init_params["textures"]) == 1
        tex = np.asarray(next(iter(scene.init_params["textures"].values())))
        assert tex.shape == (8, 8, 3)
        # spectrum textures are stored inverse-gamma'd → darker than raw
        assert tex.mean() < (30 + 200 / 2) / 255.0

    def test_render_picks_up_texture(self, textured_scene):
        img = render_scene(textured_scene, device="cpu", show_progress=False)
        assert not np.isnan(img).any()
        assert img.max() > 0  # lit floor visible

    def test_texture_gradients_flow_to_texels(self, textured_scene):
        scene = textured_scene
        plan = plan_render(scene, device="cpu", chunk_pixels=256)
        po, px = pixel_arrays(plan)
        params = leaf_copy(scene.init_params)
        key = next(iter(params["textures"]))
        (gt,) = grads(plan, params, po, px, [params["textures"][key]])
        assert gt.shape == (8, 8, 3)
        assert not torch.isnan(gt).any()
        assert (gt > 0).sum() > 4  # multiple visible texels receive gradient

    def test_optimize_texture_recovers_target(self, textured_scene):
        """Config 4: recover texel values from a rendered target image, with
        torch.optim.Adam(lr=0.05) over the texture through the train step."""
        scene = textured_scene
        plan = plan_render(scene, device="cpu", chunk_pixels=256)
        po, px = pixel_arrays(plan)
        with torch.no_grad():
            target = _render_chunk(plan, scene.init_params, po, px)[0]
        key = next(iter(scene.init_params["textures"]))
        true_tex = np.asarray(scene.init_params["textures"][key])

        params = leaf_copy(scene.init_params)
        tex = params["textures"][key]
        with torch.no_grad():
            tex.fill_(0.5)
        # texels the camera sees = those with gradient at the (wrong) start
        (g0,) = grads(plan, params, po, px, [tex])
        seen = g0.abs().sum(-1).numpy() > 0

        step = make_train_step(plan, torch.optim.Adam([tex], lr=0.05))
        for _ in range(200):
            loss = step(params, target, po, px)
        got = tex.detach().numpy()
        if seen.sum() >= 4:
            err = np.abs(got - true_tex)[seen]
            assert err.mean() < 0.05, err.mean()
        assert float(loss) < 1e-4


def test_texel_gradients_match_jax(textured_path):
    js = jax_compile(textured_path, overrides={"clip": False})
    ps = compile_scene_file(textured_path, overrides={"clip": False})
    plan = plan_render(ps, device="cpu", chunk_pixels=256)
    po, px = pixel_arrays(plan)
    jplan = jax_plan(js, chunk_pixels=256)
    jpo = jnp.asarray(jplan.pixel_offsets.reshape(-1))
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jax_render_chunk(jplan, p, jpo, jnp.asarray(
        px.numpy())))))(js.init_params)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, js.init_params), "cpu")
    key = next(iter(params["textures"]))
    (g,) = grads(plan, params, po, px, [params["textures"][key]])
    want = np.asarray(jg["textures"][key])
    got = g.numpy()
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6 * np.abs(want).max())
    assert (want != 0).sum() > 4
