"""Golden snapshot checks of the port on the shipped Cornell box
(tests/test_golden.py's statistical checks, test for test): the port's
render_scene on the CPU at 64², 4 spp, depth 2 has no NaN, is lit, shows
the red wall on the right and the green wall on the left, and the ceiling
light clips bright. The reference sphere scene skips when the reference
scenes are not mounted, as the JAX test does.

Mirrored elsewhere: determinism and chunk-size invariance
(tests/test_torch_render.py), the kernel against brute
(tests/test_torch_intersect_brute.py), the BVH against brute
(tests/test_torch_bvh.py).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from curry_pbrt_tpu_torch.render import render_scene
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file
from tests.test_golden import REF_SPHERE  # the reference's scenes, where mounted

CORNELL = Path(__file__).resolve().parents[1] / "scenes" / "cornell.pbrt"


@pytest.fixture(scope="module")
def cornell_small():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scene = compile_scene_file(CORNELL, overrides={"resolution": (64, 64), "spp": 4,
                                                       "max_depth": 2})
        return render_scene(scene, device="cpu", show_progress=False)
    finally:
        torch.set_num_threads(n)


def test_no_nans_and_lit(cornell_small):
    assert not np.isnan(cornell_small).any()
    assert cornell_small.mean() > 0.01


def test_wall_colors(cornell_small):
    # camera right = +x, so the red wall (world +x) is on the image's
    # right, the green one (x = 0) on its left
    left = cornell_small[24:40, 4:12].mean(axis=(0, 1))
    right = cornell_small[24:40, 52:60].mean(axis=(0, 1))
    assert right[0] > 1.6 * right[1], right
    assert left[1] > 1.6 * left[0], left


def test_ceiling_light_bright(cornell_small):
    assert cornell_small.max() > 5.0  # emissive patch visible (L_y ≈ 10.9)


def test_reference_sphere_scene():
    if not REF_SPHERE.exists():
        pytest.skip("reference scenes not mounted")
    scene = compile_scene_file(REF_SPHERE, overrides={"resolution": (80, 45), "spp": 2})
    img = render_scene(scene, device="cpu", show_progress=False)
    assert not np.isnan(img).any()
    assert img.max() > 3.0
    assert img.mean() > 0.02
