"""Where next-event estimation runs: csrc/nee.cu's kernels
(ops/kernels/nee.py) or the plain path, decided in models/integrators.py
on the host from the plan alone.

  - uniform_sample_one_light takes the plain path, and counts `nee_plain`
    on the open span, for CPU tensors, and `nee_refusal` names why it would
    also on the card: autograd on, an infinite light (tools/env_scene.py's
    scene), a point light, a sphere area light, a lobe kind the kernels lack
    (Oren-Nayar);
  - both benchmark scenes' plans (cornell_tex, mesh10k) are ones the
    kernels implement: with autograd off they would run on a card;
  - the plan's family-slot table (its slots: ctx.nee_fams) agrees with
    every family's is_member and mask for every material id and the miss
    id -1;
  - ops/kernels/nee.nee raises for lanes off the card (no fallback);
  - chip_smoke.py names both kernels as the profiler shows them, so its
    count of the card's kernel events matches the launch counts.

No card is needed: the rule reads the host tables and the lanes' device,
and a device is only named here. Small scenes at 8², 2 spp, depth 2.
"""

from pathlib import Path

import pytest
import torch

from curry_pbrt_tpu_torch import render
from curry_pbrt_tpu_torch.interop import params_from_numpy
from curry_pbrt_tpu_torch.models import integrators as I
from curry_pbrt_tpu_torch.ops.kernels import nee as NK
from curry_pbrt_tpu_torch.ops.kernels import shading as SH
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file, compile_scene_string
from curry_pbrt_tpu_torch.tools.env_scene import make_env_scene
from curry_pbrt_tpu_torch.utils import trace

REPO = Path(__file__).resolve().parents[1]
CELL_SCENES = ("portbench/scenes/cornell_tex.pbrt", "portbench/scenes/mesh10k.pbrt")
CUDA = torch.device("cuda")  # named only: the rule reads no tensor
SMALL = {"resolution": (8, 8), "spp": 2, "max_depth": 2}

AREA_TRI = """AttributeBegin
  AreaLightSource "diffuse" "rgb L" [5 5 5]
  Shape "trianglemesh" "integer indices" [0 1 2 2 3 0]
    "point P" [-0.5 2 -0.5  0.5 2 -0.5  0.5 2 0.5  -0.5 2 0.5]
AttributeEnd"""
POINT = 'LightSource "point" "point from" [0 2 0] "rgb I" [5 5 5]'
SPHERE = """AttributeBegin
  AreaLightSource "diffuse" "rgb L" [5 5 5]
  Translate 0 2 0
  Shape "sphere" "float radius" [0.3]
AttributeEnd"""
MATTE = 'Material "matte" "rgb Kd" [0.5 0.5 0.5]'
PLASTIC = 'Material "plastic" "rgb Kd" [0.3 0.4 0.6] "rgb Ks" [0.3 0.3 0.3] "float roughness" [0.1]'
OREN_NAYAR = 'Material "matte" "rgb Kd" [0.5 0.5 0.5] "float sigma" [20]'


def _scene_text(light: str, material: str) -> str:
    return f"""LookAt 0 1 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [45]
Sampler "halton" "integer pixelsamples" [2]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Integrator "path" "integer maxdepth" [2]
WorldBegin
{light}
{material}
Shape "trianglemesh" "integer indices" [0 1 2 2 3 0]
  "point P" [-2 -0.5 -2  2 -0.5 -2  2 -0.5 2  -2 -0.5 2]
Material "glass"
AttributeBegin
  Translate 0.6 0 0
  Shape "sphere" "float radius" [0.3]
AttributeEnd
{PLASTIC}
Shape "trianglemesh" "integer indices" [0 1 2]
  "point P" [-1 -0.4 0.5  -0.2 0.6 0.5  -0.6 -0.4 1]
WorldEnd
"""


def _plan(case, tmp_path):
    if case == "infinite light":
        scene = compile_scene_file(make_env_scene(tmp_path, res=8, spp=2, depth=2))
    elif case in ("CPU tensors", "autograd on"):
        scene = compile_scene_file(REPO / CELL_SCENES[0], SMALL)
    else:
        light, material = {"point light": (POINT, MATTE), "sphere area light": (SPHERE, MATTE),
                           "lobe kind": (AREA_TRI, OREN_NAYAR)}[case]
        scene = compile_scene_string(_scene_text(light, material))
    return render.plan_render(scene, device="cpu")


CASES = {  # case → (the device the rule is asked about, autograd, the reason it gives)
    "CPU tensors": ("cpu", False, "lanes not on a CUDA card"),
    "autograd on": ("cuda", True, "autograd on"),
    "infinite light": ("cuda", False, "an infinite light"),
    "point light": ("cuda", False, "a light of type 0"),
    "sphere area light": ("cuda", False, "a light of type 3"),
    "lobe kind": ("cuda", False, "lobe kind oren_nayar"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_plain_path_runs_and_counts_where_the_kernels_do_not(case, tmp_path):
    plan = _plan(case, tmp_path)
    device, grad, reason = CASES[case]
    with torch.set_grad_enabled(grad):
        why = I.nee_refusal(plan.ctx, torch.device(device))
        assert why is not None and why.startswith(reason), why
        assert I.nee_refusal(plan.ctx, plan.device) is not None
        params = params_from_numpy(plan.scene.init_params, "cpu")
        po, xy = render.pixel_arrays(plan)
        with trace.span("nee_dispatch_probe") as node:
            img, _, _ = render._render_chunk(plan, params, po, xy)
    depth = plan.scene.settings.max_depth  # CPU lanes: the continuation is plain too
    assert node.counts == {"nee_plain": depth, "shade_plain": depth}
    assert trace.count_totals()[("nee_dispatch_probe", "nee_plain")] >= node.counts["nee_plain"]
    assert "nee_plain    nee_dispatch_probe" in trace.summary()
    assert bool(torch.isfinite(img).all())


@pytest.mark.parametrize("path", CELL_SCENES)
def test_both_cell_scenes_are_plans_the_kernels_implement(path):
    plan = render.plan_render(compile_scene_file(REPO / path, SMALL), device="cpu")
    assert plan.ctx.nee_refusal is None
    with torch.no_grad():
        assert I.nee_refusal(plan.ctx, CUDA) is None
        assert I.nee_refusal(plan.ctx, plan.device) is not None  # these lanes are on the CPU
    with torch.enable_grad():
        assert I.nee_refusal(plan.ctx, CUDA) == "autograd on"


@pytest.mark.parametrize("scene", ["cornell_tex", "mesh10k", "mixed"])
def test_the_family_slot_table_agrees_with_family_membership(scene):
    if scene == "mixed":  # matte, glass (all delta), plastic: three families, two of them non-delta
        sc = compile_scene_string(_scene_text(AREA_TRI, MATTE))
    else:
        sc = compile_scene_file(REPO / CELL_SCENES[0 if scene == "cornell_tex" else 1], SMALL)
    ctx = render.plan_render(sc, device="cpu").ctx
    n_mats = ctx.nee_slot.shape[0] - 1
    slots = I.nondelta_families(ctx.families, ctx.registry)
    assert [id(f) for f in ctx.nee_fams] == [id(f) for f in slots]
    assert ctx.nee_slot.tolist() == I.family_slot_table(slots, n_mats).tolist()
    assert slots and len(slots) <= SH.MAX_FAMS
    ids = torch.arange(-1, n_mats, dtype=torch.int32)
    for s, fam in enumerate(slots):
        assert (ctx.nee_slot[ids.long() + 1] == s).tolist() == fam.mask(ids).tolist()
        assert fam.is_member.tolist() == (ctx.nee_slot == s).tolist()
    in_none = ctx.nee_slot[ids.long() + 1] == -1
    for fam in ctx.families:  # a lane in no non-delta family is a miss or an all-delta member
        if fam not in slots:
            assert bool((in_none | ~fam.mask(ids)).all())
    assert int(ctx.nee_slot[0]) == -1  # the miss id


def test_the_kernels_raise_for_lanes_off_the_card():
    """ops/kernels/nee.nee launches or raises: no fallback to the plain path."""
    plan = render.plan_render(compile_scene_file(REPO / CELL_SCENES[1], SMALL), device="cpu")
    calls = []
    real = I.uniform_sample_one_light

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    po, xy = render.pixel_arrays(plan)
    I.uniform_sample_one_light = record
    try:
        with torch.no_grad():
            render._render_chunk(plan, params_from_numpy(plan.scene.init_params, "cpu"), po, xy)
    finally:
        I.uniform_sample_one_light = real
    args, kw = calls[0]
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        NK.nee(*args, **kw)


@pytest.mark.parametrize("kernel", ["nee_sample", "nee_finish"])
def test_chip_smoke_names_the_kernels_the_profiler_shows(kernel):
    """chip_smoke.py holds the card's kernel events to the wrappers' launch
    counts: it must name both NEE kernels as the profiler demangles them."""
    import runpy

    smoke = runpy.run_path(str(REPO / "chip_smoke.py"), run_name="chip_smoke")
    event = (f"void curry::(anonymous namespace)::{kernel}_kernel(curry::(anonymous "
             f"namespace)::{'Sample' if kernel == 'nee_sample' else 'Finish'}Args)")
    assert smoke["port_kernel"](event) == (kernel, "")
    assert smoke["launched_kernels"]({kernel: 3, "tri_any": 0}) == {(kernel, ""): 3}
    assert kernel in smoke["NEE_COUNTERS"]
