"""The slice as a whole: the PyTorch port's render_scene (path integrator,
box film, kernel intersectors — plain versions on the CPU) against the JAX
package.

  - cornell_tex and cornell, and spheres.pbrt under the path integrator
    (point, distant and spherical area lights, spheres only), at 24², 2 spp,
    depth 2: JAX render_scene(intersector="pallas") and the port's
    render_scene(device="cpu") from the same parameters (the JAX pytree
    exported as numpy and loaded with params_from_numpy), and their
    traced-segment counts;
  - the port against tests/goldens/{cornell,cornell_tex}.npy (JAX CPU
    renders at 32², 4 spp, depth 3 through the brute intersector) and
    tests/goldens/mesh10k.npy (32², 4 spp, depth 4: plastic's GGX lobe,
    supers and kd cells);
  - a generated field of 300 spheres, one matte material each (the sphere
    cluster kernel from 129 spheres up, a 300-member material family), at
    16², 2 spp, depth 2 against JAX render_scene(intersector="pallas"),
    with its segment count.

Tolerance: allclose(rtol=1e-4, atol=1e-4), the JAX package's own
cross-backend tolerance (tests/test_golden.py), with at most 1% of the
values outside it and the image sum within 1e-3 relative. Outliers come
from branch flips (a texel or light pick one ULP across a boundary) between
XLA's CPU lowering, which contracts a*b+c into FMAs, and the port's
separately rounded ops.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curry_pbrt_tpu.render import _chunked_pixel_arrays as jax_chunks
from curry_pbrt_tpu.render import _render_chunk_stats as jax_chunk_stats
from curry_pbrt_tpu.render import plan_render as jax_plan
from curry_pbrt_tpu.render import render_scene as jax_render
from curry_pbrt_tpu.sceneio.compiler import compile_scene_file as jax_compile
from curry_pbrt_tpu_torch.interop import params_from_numpy
from curry_pbrt_tpu_torch.render import render_scene
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file

REPO = Path(__file__).resolve().parents[1]
RTOL = ATOL = 1e-4
MAX_OUTLIER_FRAC = 0.01
SUM_RTOL = 1e-3


def _assert_image_close(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    outside = ~np.isclose(img, ref, rtol=RTOL, atol=ATOL)
    assert outside.mean() <= MAX_OUTLIER_FRAC, (outside.sum(), np.abs(img - ref).max())
    assert abs(img.sum() - ref.sum()) <= SUM_RTOL * abs(ref.sum())


def _jax_segments(scene):
    plan = jax_plan(scene, intersector="pallas")
    po, px, _ = jax_chunks(plan)
    return sum(
        float(jax_chunk_stats(plan, scene.init_params, jnp.asarray(po[k]), jnp.asarray(px[k]))[1])
        for k in range(po.shape[0])
    )


@pytest.mark.parametrize("name", ["cornell_tex", "cornell", "spheres"])
def test_port_matches_jax_kernel_path(name):
    ov = {"resolution": (24, 24), "spp": 2, "max_depth": 2, "integrator": "path"}
    js = jax_compile(REPO / "scenes" / f"{name}.pbrt", overrides=ov)
    ps = compile_scene_file(REPO / "scenes" / f"{name}.pbrt", overrides=ov)
    ref = jax_render(js, show_progress=False, intersector="pallas")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, js.init_params), "cpu")
    img, segments = render_scene(ps, params=params, device="cpu", show_progress=False,
                                 count_rays=True)
    _assert_image_close(img, ref)
    assert segments == int(_jax_segments(js))


@pytest.mark.parametrize("name,depth", [("cornell", 3), ("cornell_tex", 3), ("mesh10k", 4)])
def test_port_matches_golden(name, depth):
    ov = {"resolution": (32, 32), "spp": 4, "max_depth": depth}
    ps = compile_scene_file(REPO / "scenes" / f"{name}.pbrt", overrides=ov)
    img = render_scene(ps, device="cpu", show_progress=False)
    _assert_image_close(img, np.load(REPO / "tests" / "goldens" / f"{name}.npy"))


def test_chunking_and_params_do_not_change_the_image():
    """Chunk size is a schedule, not a result: bit-equal images and equal
    segment counts. Params given as tensors or numpy leaves are the same."""
    ov = {"resolution": (16, 12), "spp": 2, "max_depth": 3}
    ps = compile_scene_file(REPO / "scenes" / "cornell_tex.pbrt", overrides=ov)
    a, sa = render_scene(ps, device="cpu", chunk_pixels=192, show_progress=False, count_rays=True)
    b, sb = render_scene(ps, device="cpu", chunk_pixels=50, show_progress=False, count_rays=True)
    np.testing.assert_array_equal(a, b)
    assert sa == sb
    as_np = {"materials": {k: {s: v.numpy() for s, v in d.items()}
                           for k, d in ps.init_params["materials"].items()},
             "textures": {k: v.numpy() for k, v in ps.init_params["textures"].items()},
             "light_L": ps.init_params["light_L"].numpy()}
    c = render_scene(ps, params=as_np, device="cpu", chunk_pixels=64, show_progress=False)
    np.testing.assert_array_equal(a, c)


def test_params_drive_the_image():
    """Doubling every light's radiance doubles the image (linearity in L)."""
    ov = {"resolution": (8, 8), "spp": 2, "max_depth": 2}
    ps = compile_scene_file(REPO / "scenes" / "cornell.pbrt", overrides=ov)
    a = render_scene(ps, device="cpu", show_progress=False)
    params = dict(ps.init_params, light_L=ps.init_params["light_L"] * 2.0)
    b = render_scene(ps, params=params, device="cpu", show_progress=False)
    np.testing.assert_allclose(b, 2.0 * a, rtol=1e-5, atol=1e-6)
    assert a.sum() > 0


def test_cli_renders_a_png(tmp_path):
    from curry_pbrt_tpu_torch.cli import main
    from curry_pbrt_tpu_torch.utils.imageio import read_png

    out = tmp_path / "c.png"
    main([str(REPO / "scenes" / "cornell.pbrt"), "-o", str(out), "--device", "cpu",
          "--res", "8", "8", "--spp", "1", "--max-depth", "1", "--quiet"])
    img = read_png(out)
    assert img.shape == (8, 8, 3) and img.max() > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            main([str(REPO / "scenes" / "cornell.pbrt"), "-o", str(out), "--quiet"])


def _sphere_field(path, n, seed):
    """A field of n spheres, each with its own matte material, under a
    distant light and an area lamp, in the format of
    tools/make_sphere_scene.py."""
    rng = np.random.default_rng(seed)
    lines = [
        "LookAt 0 0 -40  0 0 0  0 1 0",
        'Camera "perspective" "float fov" [50]',
        'Sampler "halton" "integer pixelsamples" [2]',
        'Film "image" "integer xresolution" [16] "integer yresolution" [16]',
        'Integrator "path" "integer maxdepth" [2]',
        "WorldBegin",
        'LightSource "distant" "point from" [-40 60 -80] "point to" [0 0 0] "rgb L" [2.5 2.4 2.2]',
        "AttributeBegin",
        'AreaLightSource "diffuse" "rgb L" [12 11 9]',
        'Material "matte"',
        'Shape "trianglemesh" "integer indices" [0 1 2 2 3 0]',
        '  "point P" [-6 23 -6  6 23 -6  6 23 6  -6 23 6]',
        "AttributeEnd",
    ]
    for _ in range(n):
        x, y, z = rng.uniform(-15, 15, 3)
        kd = rng.uniform(0.2, 0.8, 3)
        lines += [
            "AttributeBegin",
            f'Material "matte" "rgb Kd" [{kd[0]:.3f} {kd[1]:.3f} {kd[2]:.3f}]',
            f"Translate {x:.4f} {y:.4f} {z:.4f}",
            f'Shape "sphere" "float radius" [{rng.uniform(0.25, 1.2):.4f}]',
            "AttributeEnd",
        ]
    path.write_text("\n".join(lines) + "\n")
    return path


def test_sphere_field_matches_jax(tmp_path):
    path = _sphere_field(tmp_path / "field.pbrt", 300, seed=21)
    js, ps = jax_compile(path), compile_scene_file(path)
    ref = jax_render(js, show_progress=False, intersector="pallas")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, js.init_params), "cpu")
    img, segments = render_scene(ps, params=params, device="cpu", show_progress=False,
                                 count_rays=True)
    assert ref.mean() > 0.01  # spheres really lit
    _assert_image_close(img, ref)
    assert segments == int(_jax_segments(js))
