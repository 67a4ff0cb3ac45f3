"""End-to-end analytic checks of the port (tests/test_render_analytic.py,
test for test): scenes with closed-form answers — white furnace, inverse
square falloff, emitter radiance, a mirror, a glass ball — rendered by the
port's render_scene on the CPU (the kernels' plain versions) at the JAX
tests' sizes (16² to 33²) and held to the same physical identities with
the same tolerances. No JAX render is needed: the answers are physics.
The scene texts are the JAX tests' own.
"""

import numpy as np
import pytest
import torch

from curry_pbrt_tpu_torch.render import render_scene
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_string
from tests.test_render_analytic import (
    AREA_LIGHT_VISIBLE,
    GLASS_SCENE,
    MIRROR_SCENE,
    POINT_LIGHT_PLANE,
    SPHERE_FURNACE,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tier-1 run puts several xdist workers on
    the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def render_inline(text, **overrides):
    """clip=False disables the camera frustum clipper, which culls any
    non-emissive primitive whose bound corners are all off-screen."""
    scene = compile_scene_string(text, overrides=overrides)
    return render_scene(scene, device="cpu", show_progress=False)


def test_white_furnace_sphere():
    """Lambertian sphere under a constant unit environment: every sphere
    pixel ≈ albedo, background = 1."""
    img = render_inline(SPHERE_FURNACE)
    assert abs(img[0, 0].mean() - 1.0) < 1e-3
    center = img[14:18, 14:18].mean()
    assert abs(center - 0.6) < 0.03, center
    assert not np.isnan(img).any()


def test_inverse_square_lambert():
    """Plane z=2, point light I=4 at z=1 on the axis: L = I/d² · kd/π ·
    cosθ on the axis (4·0.5/π) and at world x=0.5 (d² = 1.25)."""
    img = render_inline(POINT_LIGHT_PLANE, clip=False)
    expect = 4.0 * 0.5 / np.pi
    center = img[16, 16].mean()
    assert abs(center - expect) < 0.02 * expect, (center, expect)
    l = 4.0 / 1.25 * (1.0 / np.sqrt(1.25)) * 0.5 / np.pi
    px = img[16, 28].mean()
    assert abs(px - l) < 0.05 * l, (px, l)
    assert not np.isnan(img).any()


def test_emitter_radiance_direct():
    """Camera ray hits the emissive quad: pixel = L exactly (bounce-0
    emission)."""
    img = render_inline(AREA_LIGHT_VISIBLE)
    np.testing.assert_allclose(img[8, 8], [2, 3, 4], rtol=1e-5)


def test_mirror_shows_light():
    """A mirror plane reflects the emissive sphere behind the camera: the
    center pixel sees its radiance 5."""
    img = render_inline(MIRROR_SCENE, clip=False)
    center = img[15:17, 15:17].mean()
    assert abs(center - 5.0) < 0.05, center
    assert not np.isnan(img).any()


def test_glass_energy_bounded():
    """Glass ball in front of a big emitter: finite, at most the source's
    radiance, ~0.85 of it through the center."""
    img = render_inline(GLASS_SCENE)
    assert not np.isnan(img).any()
    assert img.max() < 3.0
    center = img[12, 12].mean()
    assert 0.5 < center <= 1.01, center
