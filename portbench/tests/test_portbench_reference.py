"""The plain reference against the port's CPU path (the kernels' plain
versions) at tiny sizes: the same scene files and seed give the same
pixels and the same traced segments. Only this test imports the port
beside the reference."""

import numpy as np
import pytest
import torch

from portbench.ref.render import Reference, bf16_store
from portbench.tests.helpers import SEED, tiny_cell


@pytest.mark.parametrize("workload", ["cornell_tex_512.render", "mesh10k_1024.render"])
def test_reference_matches_the_ports_cpu_path(workload):
    from curry_pbrt_tpu_torch.render import plan_render, render_plan
    from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file

    cell = tiny_cell(workload)
    ref = Reference(cell.scene_path, cell.overrides(SEED), "cpu")
    img_r, seg_r = ref.render()
    plan = plan_render(compile_scene_file(cell.scene_path, cell.overrides(SEED)), device="cpu")
    img_p, seg_p = render_plan(plan, show_progress=False, count_rays=True)
    assert seg_p == seg_r > 0
    np.testing.assert_allclose(img_p.reshape(-1, 3), img_r.numpy(), rtol=1e-5, atol=1e-6)
    assert float(img_r.sum()) > 0


def test_a_pixel_sample_renders_the_frames_pixels():
    """Each ray depends only on its pixel and sample: rendering a subset
    gives those pixels of the whole frame, in the subset's order."""
    cell = tiny_cell("mesh10k_1024.render")
    ref = Reference(cell.scene_path, cell.overrides(SEED), "cpu")
    whole, _ = ref.render()
    pixels = torch.tensor([140, 3, 77, 0])
    part, _ = ref.render(pixels)
    torch.testing.assert_close(part, whole[pixels], rtol=1e-6, atol=1e-7)


def test_the_bf16_store_changes_the_render():
    cell = tiny_cell("cornell_tex_512.render")
    ref = Reference(cell.scene_path, cell.overrides(SEED), "cpu")
    full, _ = ref.render()
    low, _ = ref.render(store=bf16_store)
    assert not torch.equal(full, low)
    assert float((full - low).abs().max()) < 0.5 * float(full.abs().max())


def test_the_seed_moves_the_samples():
    cell = tiny_cell("cornell_tex_512.render")
    a, _ = Reference(cell.scene_path, cell.overrides(SEED), "cpu").render()
    b, _ = Reference(cell.scene_path, cell.overrides(SEED + 1), "cpu").render()
    assert not torch.equal(a, b)
