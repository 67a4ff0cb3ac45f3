"""The port's EXR reader and thin-lens camera (curry_pbrt_tpu_torch/utils/
imageio.read_exr / read_image, models/camera.generate_rays) against the
EXR and thin-lens tests of tests/test_io_camera_env.py, test for test, with
their tolerances (the environment-light tests of that file are
tests/test_torch_env.py's).

The EXR writer below is test code: a copy of the JAX test's minimal
single-part scanline writer (FLOAT channels, no compression). The
thin-lens rays are also held against the JAX package's generate_rays on
the same film points and lens samples, within 1e-5 (XLA's CPU FMAs).
"""

import struct

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from curry_pbrt_tpu.models.camera import generate_rays as jax_generate_rays
from curry_pbrt_tpu.models.camera import make_perspective_camera as jax_camera
from curry_pbrt_tpu_torch.models.camera import generate_rays, make_perspective_camera
from curry_pbrt_tpu_torch.ops.math import inverse_gamma_correct
from curry_pbrt_tpu_torch.render import render_scene
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_string
from curry_pbrt_tpu_torch.utils.imageio import read_exr, read_image


def _write_minimal_exr(path, rgb: np.ndarray):
    """Single-part scanline EXR, FLOAT channels, compression NONE."""
    h, w = rgb.shape[:2]

    def attr(name, atype, payload):
        return name.encode() + b"\0" + atype.encode() + b"\0" + struct.pack(
            "<I", len(payload)) + payload

    chlist = b""
    for c in (b"B", b"G", b"R"):
        chlist += c + b"\0" + struct.pack("<IIII", 2, 0, 1, 1)  # FLOAT
    chlist += b"\0"
    dw = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (
        attr("channels", "chlist", chlist)
        + attr("compression", "compression", b"\0")
        + attr("dataWindow", "box2i", dw)
        + attr("displayWindow", "box2i", dw)
        + attr("lineOrder", "lineOrder", b"\0")
        + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
        + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\0"
    )
    body = b""
    offsets = []
    base = 8 + len(header) + 8 * h
    for y in range(h):
        offsets.append(base + len(body))
        line = b""
        for ci in (2, 1, 0):  # channels stored alphabetically: B, G, R
            line += rgb[y, :, ci].astype("<f4").tobytes()
        body += struct.pack("<iI", y, len(line)) + line
    with open(path, "wb") as f:
        f.write(b"\x76\x2f\x31\x01" + struct.pack("<I", 2))
        f.write(header)
        f.write(struct.pack("<%dQ" % h, *offsets))
        f.write(body)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TestExr:
    def test_roundtrip_float(self, tmp_path):
        img = np.random.RandomState(3).rand(6, 9, 3).astype(np.float32) * 4.0  # HDR range
        _write_minimal_exr(tmp_path / "t.exr", img)
        np.testing.assert_allclose(read_exr(tmp_path / "t.exr"), img, rtol=0, atol=0)

    def test_read_image_dispatches_on_extension(self, tmp_path):
        img = np.full((4, 4, 3), 2.5, np.float32)
        _write_minimal_exr(tmp_path / "d.exr", img)
        np.testing.assert_allclose(read_image(tmp_path / "d.exr"), img)

    def test_exr_texture_in_scene(self, tmp_path):
        """Spectrum textures get inverse gamma whatever the file format, as
        the reference applies it to EXR too (texture_map.rs:41-46)."""
        img = np.full((4, 4, 3), 0.5, np.float32)
        _write_minimal_exr(tmp_path / "t.exr", img)
        text = """
WorldBegin
Texture "t" "spectrum" "imagemap" "string filename" ["t.exr"]
Material "matte" "texture Kd" ["t"]
Shape "trianglemesh" "integer indices" [0 1 2] "point P" [0 0 2 1 0 2 0 1 2]
WorldEnd
"""
        scene = compile_scene_string(text, base_dir=tmp_path, overrides={"clip": False})
        tex = np.asarray(next(iter(scene.init_params["textures"].values())))
        np.testing.assert_allclose(tex, inverse_gamma_correct(img.astype(np.float64)), rtol=1e-5)


class TestThinLens:
    def test_lens_rays_converge_at_focal_plane(self):
        """Every lens sample's ray through one film point passes through
        the same focal-plane point (lens.rs:24-33)."""
        args = (60.0, (64, 64), None)
        kw = dict(lens_radius=0.4, focal_distance=5.0)
        cam = make_perspective_camera(*args, **kw)
        film_xy = np.tile([[17.3, 40.2]], (16, 1)).astype(np.float32)
        lens_u = np.random.RandomState(0).rand(16, 2).astype(np.float32)
        o, d = generate_rays(cam, torch.from_numpy(film_xy), torch.from_numpy(lens_u))
        o, d = o.numpy(), d.numpy()
        assert np.ptp(o, axis=0).max() > 1e-3  # origins spread over the lens
        t = (5.0 - o[:, 2]) / d[:, 2]
        focus = o + t[:, None] * d
        assert np.ptp(focus, axis=0).max() < 1e-4  # all meet at one point
        jo, jd = jax_generate_rays(jax_camera(*args, **kw), jnp.asarray(film_xy), jnp.asarray(lens_u))
        np.testing.assert_allclose(o, np.asarray(jo), rtol=0, atol=1e-5)
        np.testing.assert_allclose(d, np.asarray(jd), rtol=0, atol=1e-5)

    def test_pinhole_ignores_lens(self):
        cam = make_perspective_camera(60.0, (64, 64))
        assert not cam.has_lens
        o, _d = generate_rays(cam, torch.tensor([[32.0, 32.0]]), None)
        np.testing.assert_allclose(o.numpy(), 0.0, atol=1e-7)

    def test_dof_render_blurs_off_focus(self):
        """A thin bright strip at the focal plane stays sharp; an identical
        strip far behind it dims and widens with the lens open."""

        text = """
Film "image" "integer xresolution" [48] "integer yresolution" [16]
Sampler "halton" "integer pixelsamples" [%d]
Camera "perspective" "float fov" [40]
    "float lensradius" [%s] "float focaldistance" [4]
Integrator "path" "integer maxdepth" [1]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [8 8 8]
  Shape "trianglemesh" "integer indices" [0 1 2 2 3 0]
    "point P" [-0.05 -1 4   0.05 -1 4   0.05 1 4   -0.05 1 4]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [8 8 8]
  Shape "trianglemesh" "integer indices" [0 1 2 2 3 0]
    "point P" [2.8 -3 12   3.1 -3 12   3.1 3 12   2.8 3 12]
AttributeEnd
WorldEnd
"""

        def render(spp, radius):
            scene = compile_scene_string(text % (spp, radius), overrides={"clip": False})
            return render_scene(scene, device="cpu", show_progress=False)

        sharp, dof = render(32, "0"), render(128, "0.35")
        row_s, row_d = sharp[8].mean(-1), dof[8].mean(-1)
        infocus, offfocus = slice(22, 27), slice(27, 36)

        def lit_width(row):
            lit = np.nonzero(row > 0.05)[0]
            return lit.max() - lit.min() + 1 if len(lit) else 0

        assert row_d[offfocus].max() < 0.8 * row_s[offfocus].max()
        assert lit_width(row_d[offfocus]) > lit_width(row_s[offfocus])
        assert row_d[infocus].max() > 0.8 * row_s[infocus].max()
        assert not np.isnan(dof).any()
