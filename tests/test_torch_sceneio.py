"""Scene front end of the PyTorch port against the JAX package: every
compiled array of the shipped scenes must be identical, and the port's
stdlib PNG codec must agree with PIL."""

import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from curry_pbrt_tpu.sceneio.compiler import compile_scene_file as jax_compile
from curry_pbrt_tpu_torch.interop import params_from_numpy, scene_arrays_from_numpy
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file as port_compile
from curry_pbrt_tpu_torch.utils.imageio import read_image, read_png, write_png

SCENES = Path(__file__).resolve().parents[1] / "scenes"


def _np(x):
    return np.asarray(x)


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
        return
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=path)


# mesh600k is `slow`: each package's compile of its 600k triangles is a
# per-triangle Python loop of about a minute
@pytest.mark.parametrize("name", ["cornell", "cornell_tex", "spheres", "mesh10k", "mesh100k",
                                  "spherefield10k", pytest.param("mesh600k", marks=pytest.mark.slow)])
def test_compiled_arrays_identical(name):
    ov = {"resolution": (64, 48), "spp": 3, "max_depth": 4, "seed": 7}
    js = jax_compile(SCENES / f"{name}.pbrt", overrides=ov)
    ps = port_compile(SCENES / f"{name}.pbrt", overrides=ov)

    for f in ("p0", "p1", "p2", "prim"):
        np.testing.assert_array_equal(_np(getattr(js.tris, f)), _np(getattr(ps.tris, f)), f)
    for f in ("o2w", "w2o", "radius", "prim"):
        np.testing.assert_array_equal(_np(getattr(js.spheres, f)), _np(getattr(ps.spheres, f)), f)
    np.testing.assert_array_equal(js.prim_mat, ps.prim_mat)
    np.testing.assert_array_equal(js.prim_light, ps.prim_light)
    assert js.lights._fields == ps.lights._fields
    for f in js.lights._fields:
        np.testing.assert_array_equal(_np(getattr(js.lights, f)), getattr(ps.lights, f), f)
    assert len(js.envs) == len(ps.envs)
    for je, pe in zip(js.envs, ps.envs):
        np.testing.assert_array_equal(_np(je.image), pe.image)
        for f in je.dist._fields:
            np.testing.assert_array_equal(_np(getattr(je.dist, f)), getattr(pe.dist, f), f)
    for f in ("raster_to_camera", "camera_to_world"):
        np.testing.assert_array_equal(getattr(js.camera, f), getattr(ps.camera, f), f)
    assert (js.camera.resolution, js.camera.lens_radius, js.camera.focal_distance) == (
        ps.camera.resolution, ps.camera.lens_radius, ps.camera.focal_distance)
    assert vars(js.settings) == vars(ps.settings)

    def mats(sc):  # TexRef is a class of each package: compare its fields
        return [(m.kind, m.mat_id, {k: (r.kind, r.const, r.tex) for k, r in m.refs.items()},
                 m.lobe_plan) for m in sc.materials]

    assert mats(js) == mats(ps)
    assert sorted(js.material_registry) == sorted(ps.material_registry)
    # params: the JAX pytree, exported as numpy, loads to the port's own
    jparams = {
        "materials": {k: {s: _np(v) for s, v in d.items()}
                      for k, d in js.init_params["materials"].items()},
        "textures": {k: _np(v) for k, v in js.init_params["textures"].items()},
        "light_L": _np(js.init_params["light_L"]),
    }
    _assert_tree_equal(params_from_numpy(jparams, "cpu"), params_from_numpy(ps.init_params, "cpu"))
    # and the JAX compile's geometry loads into the port's scene unchanged
    loaded = scene_arrays_from_numpy(ps, js.tris, js.spheres, js.lights)
    for f in ("p0", "prim"):
        np.testing.assert_array_equal(getattr(loaded.tris, f), getattr(ps.tris, f))


def test_png_reader_matches_pil_on_the_texture():
    path = SCENES / "box-texture.png"
    ref = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(read_png(path), ref)
    np.testing.assert_array_equal(read_image(path), ref.astype(np.float32) / 255.0)


def _png_with_filter(img: np.ndarray, ftype: int) -> bytes:
    """Encode (H, W, C) uint8 with one PNG filter type on every row."""
    h, w, c = img.shape
    stride = w * c
    raw = img.reshape(h, stride).astype(np.int64)
    out = bytearray()
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        line = raw[y]
        left = np.concatenate([np.zeros(c, np.int64), line[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if ftype == 0:
            f = line
        elif ftype == 1:
            f = line - left
        elif ftype == 2:
            f = line - prev
        elif ftype == 3:
            f = line - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            f = line - pred
        out.append(ftype)
        out += bytes((f % 256).astype(np.uint8))
        prev = line

    def chunk(t, data):
        return struct.pack(">I", len(data)) + t + data + struct.pack(">I", zlib.crc32(t + data))

    color = {3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_reader_every_filter(tmp_path, ftype, channels):
    img = np.random.default_rng(ftype * 10 + channels).integers(
        0, 256, (7, 9, channels), dtype=np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_png_with_filter(img, ftype))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)  # the encoder is valid
    np.testing.assert_array_equal(read_png(path), img)


def test_png_writer_reads_back_in_pil(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (5, 11, 3), dtype=np.uint8)
    write_png(tmp_path / "w.png", img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "w.png")), img)
    np.testing.assert_array_equal(read_png(tmp_path / "w.png"), img)


def test_params_travel_together_and_keep_gradients():
    """Leaves that need a copy are moved as one buffer per dtype (views of
    it, values unchanged); a leaf that requires grad is moved on its own and
    stays differentiable."""
    import torch

    kd = torch.tensor([0.2, 0.3, 0.4], requires_grad=True)
    tree = {"materials": {"0": {"Kd": kd, "sigma": np.float32(2.0)},
                          "1": {"Kd": np.array([0.5, 0.6, 0.7], np.float32)}},
            "light_L": np.ones((2, 3), np.float32), "ids": np.arange(3, dtype=np.int32)}
    out = params_from_numpy(tree, "cpu")
    assert out["materials"]["0"]["Kd"] is kd
    np.testing.assert_array_equal(out["materials"]["1"]["Kd"].numpy(),
                                  np.array([0.5, 0.6, 0.7], np.float32))
    assert out["materials"]["0"]["sigma"].shape == () and float(out["materials"]["0"]["sigma"]) == 2.0
    assert out["light_L"].shape == (2, 3) and out["ids"].dtype == torch.int32
    # the float32 leaves share one buffer
    assert out["light_L"].untyped_storage().data_ptr() == \
        out["materials"]["1"]["Kd"].untyped_storage().data_ptr()
    (out["materials"]["0"]["Kd"].sum() * 2.0).backward()
    np.testing.assert_array_equal(kd.grad.numpy(), [2.0, 2.0, 2.0])
