"""Where the path continuation runs: csrc/shade.cu's kernel
(ops/kernels/shade.py) or the plain path, decided in models/integrators.py
on the host from the plan alone.

  - continue_path takes the plain path, and counts `shade_plain` on the
    open span, for CPU tensors, and `continuation_refusal` names why it
    would also on the card: autograd on, an Oren-Nayar matte, a translucent
    material's transmission lobes (lambert_t, ggx_t), more families than
    the kernel's slots;
  - both benchmark scenes' plans (cornell_tex, mesh10k) are ones the kernel
    implements: with autograd off they would run on a card;
  - the plan's all-family slot table (its slots: ctx.families, delta-only
    families included) agrees with every family's mask for every material
    id and the miss id -1;
  - ops/kernels/shade.continuation raises for lanes off the card (no
    fallback);
  - chip_smoke.py names the kernel as the profiler shows it, so its count of
    the card's kernel events matches the launch counts.

No card is needed: the rule reads the host tables and the lanes' device,
and a device is only named here. Small scenes at 8², 2 spp, depth 2.
"""

from pathlib import Path

import pytest
import torch

from curry_pbrt_tpu_torch import render
from curry_pbrt_tpu_torch.interop import params_from_numpy
from curry_pbrt_tpu_torch.models import integrators as I
from curry_pbrt_tpu_torch.ops.kernels import shade as SK
from curry_pbrt_tpu_torch.ops.kernels import shading as SH
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file, compile_scene_string
from curry_pbrt_tpu_torch.utils import trace

REPO = Path(__file__).resolve().parents[1]
CELL_SCENES = ("portbench/scenes/cornell_tex.pbrt", "portbench/scenes/mesh10k.pbrt")
CUDA = torch.device("cuda")  # named only: the rule reads no tensor
SMALL = {"resolution": (8, 8), "spp": 2, "max_depth": 2}

MATTE = 'Material "matte" "rgb Kd" [0.5 0.5 0.5]'
OREN_NAYAR = 'Material "matte" "rgb Kd" [0.5 0.5 0.5] "float sigma" [20]'
LAMBERT_T = 'Material "translucent" "rgb Kd" [0.5 0.5 0.5] "rgb Ks" [0 0 0]'
GGX_T = 'Material "translucent" "rgb Kd" [0 0 0] "rgb Ks" [0.3 0.3 0.3]'
# nine materials of nine families, each of kinds the kernel implements
NINE = ['Material "matte" "rgb Kd" [0.5 0.5 0.5]', 'Material "glass"', 'Material "mirror"',
        'Material "plastic" "rgb Kd" [0.3 0.4 0.6] "rgb Ks" [0.3 0.3 0.3]',
        'Material "plastic" "rgb Kd" [0.3 0.4 0.6] "rgb Ks" [0 0 0]',
        'Material "plastic" "rgb Kd" [0 0 0] "rgb Ks" [0.3 0.3 0.3]',
        'Material "uber" "rgb Kd" [0.3 0.4 0.6] "rgb Ks" [0 0 0]',
        'Material "uber" "rgb Kd" [0 0 0] "rgb Ks" [0.3 0.3 0.3]',
        'Material "uber" "rgb Kd" [0.3 0.4 0.6] "rgb Ks" [0.2 0.2 0.2] "rgb Kr" [0.3 0.3 0.3]']


def _scene_text(materials) -> str:
    """A ground plane of the first material and a small triangle of each
    other one, under an area light."""
    shapes = []
    for j, mat in enumerate(materials[1:]):
        x = -2.0 + 0.45 * j
        shapes.append(f'{mat}\nShape "trianglemesh" "integer indices" [0 1 2]\n'
                      f'  "point P" [{x} -0.4 0.5  {x + 0.2} 0.4 0.5  {x + 0.4} -0.4 0.5]')
    return f"""LookAt 0 1 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [45]
Sampler "halton" "integer pixelsamples" [2]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Integrator "path" "integer maxdepth" [2]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [5 5 5]
  Shape "trianglemesh" "integer indices" [0 1 2 2 3 0]
    "point P" [-0.5 2 -0.5  0.5 2 -0.5  0.5 2 0.5  -0.5 2 0.5]
AttributeEnd
{materials[0]}
Shape "trianglemesh" "integer indices" [0 1 2 2 3 0]
  "point P" [-2 -0.5 -2  2 -0.5 -2  2 -0.5 2  -2 -0.5 2]
{chr(10).join(shapes)}
WorldEnd
"""


def _plan(case):
    if case in ("CPU tensors", "autograd on"):
        scene = compile_scene_file(REPO / CELL_SCENES[0], SMALL)
    else:
        materials = {"Oren-Nayar": [MATTE, OREN_NAYAR], "lambert_t": [MATTE, LAMBERT_T],
                     "ggx_t": [MATTE, GGX_T], "too many families": NINE}[case]
        scene = compile_scene_string(_scene_text(materials))
    return render.plan_render(scene, device="cpu")


CASES = {  # case → (the device the rule is asked about, autograd, the reason it gives)
    "CPU tensors": ("cpu", False, "lanes not on a CUDA card"),
    "autograd on": ("cuda", True, "autograd on"),
    "Oren-Nayar": ("cuda", False, "lobe kind oren_nayar"),
    "lambert_t": ("cuda", False, "lobe kind lambert_t"),
    "ggx_t": ("cuda", False, "lobe kind ggx_t"),
    "too many families": ("cuda", False, f"9 families (at most {SH.MAX_FAMS})"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_plain_path_runs_and_counts_where_the_kernel_does_not(case):
    plan = _plan(case)
    device, grad, reason = CASES[case]
    with torch.set_grad_enabled(grad):
        why = I.continuation_refusal(plan.ctx, torch.device(device))
        assert why is not None and why.startswith(reason), why
        assert I.continuation_refusal(plan.ctx, plan.device) is not None
        params = params_from_numpy(plan.scene.init_params, "cpu")
        po, xy = render.pixel_arrays(plan)
        with trace.span("shade_dispatch_probe") as node:
            img, _, _ = render._render_chunk(plan, params, po, xy)
    assert node.counts["shade_plain"] == plan.scene.settings.max_depth
    assert "shade_kernel" not in node.counts
    assert trace.count_totals()[("shade_dispatch_probe", "shade_plain")] >= node.counts[
        "shade_plain"]
    assert f"{'shade_plain':<12} shade_dispatch_probe" in trace.summary()
    assert bool(torch.isfinite(img).all())


@pytest.mark.parametrize("path", CELL_SCENES)
def test_both_cell_scenes_are_plans_the_kernel_implements(path):
    plan = render.plan_render(compile_scene_file(REPO / path, SMALL), device="cpu")
    assert plan.ctx.shade_refusal is None
    with torch.no_grad():
        assert I.continuation_refusal(plan.ctx, CUDA) is None
        assert I.continuation_refusal(plan.ctx, plan.device) is not None  # CPU lanes
    with torch.enable_grad():
        assert I.continuation_refusal(plan.ctx, CUDA) == "autograd on"


@pytest.mark.parametrize("scene", ["cornell_tex", "mesh10k", "mixed"])
def test_the_all_family_slot_table_agrees_with_every_family_mask(scene):
    if scene == "mixed":  # nine families, delta-only ones (glass, mirror) among them
        sc = compile_scene_string(_scene_text(NINE))
    else:
        sc = compile_scene_file(REPO / CELL_SCENES[0 if scene == "cornell_tex" else 1], SMALL)
    ctx = render.plan_render(sc, device="cpu").ctx
    n_mats = ctx.shade_slot.shape[0] - 1
    assert ctx.shade_slot.tolist() == I.family_slot_table(ctx.families, n_mats).tolist()
    ids = torch.arange(-1, n_mats, dtype=torch.int32)
    slot = ctx.shade_slot[ids.long() + 1]
    for s, fam in enumerate(ctx.families):
        assert (slot == s).tolist() == fam.mask(ids).tolist()
    # a material id with no family is one no primitive uses, or the miss id
    member = torch.zeros_like(ids, dtype=torch.bool)
    for fam in ctx.families:
        member |= fam.mask(ids)
    assert (slot == -1).tolist() == (~member).tolist()
    assert int(ctx.shade_slot[0]) == -1
    if scene != "mixed":
        assert len(ctx.families) <= SH.MAX_FAMS


def test_the_kernel_raises_for_lanes_off_the_card():
    """ops/kernels/shade.continuation launches or raises: no fallback to the
    plain path."""
    plan = render.plan_render(compile_scene_file(REPO / CELL_SCENES[1], SMALL), device="cpu")
    calls = []
    real = I.continue_path

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    po, xy = render.pixel_arrays(plan)
    I.continue_path = record
    try:
        with torch.no_grad():
            render._render_chunk(plan, params_from_numpy(plan.scene.init_params, "cpu"), po, xy)
    finally:
        I.continue_path = real
    assert len(calls) == plan.scene.settings.max_depth
    args, kw = calls[0]
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        SK.continuation(*args, **kw)


def test_chip_smoke_names_the_kernel_the_profiler_shows():
    """chip_smoke.py holds the card's kernel events to the wrappers' launch
    counts: it must name the continuation kernel as the profiler demangles
    it."""
    import runpy

    smoke = runpy.run_path(str(REPO / "chip_smoke.py"), run_name="chip_smoke")
    event = ("void curry::(anonymous namespace)::continue_kernel(curry::(anonymous "
             "namespace)::ContinueArgs)")
    assert smoke["port_kernel"](event) == ("shade_continue", "")
    assert smoke["launched_kernels"]({"shade_continue": 5, "tri_any": 0}) == {
        ("shade_continue", ""): 5}
    assert "shade_continue" in smoke["SHADE_COUNTERS"]
