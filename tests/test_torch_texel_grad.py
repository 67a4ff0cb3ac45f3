"""The texel gather as an autograd Function (ops/kernels/texel_grad.py):
TexelGather's forward is the plain row gather, its CPU backward is what
autograd computes through the plain gather, bit for bit, and eval_texref
takes it only under autograd on a texture that requires grad. The CUDA
segment sum is held against float64 sums in
tests/test_torch_texel_grad_card.py.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from curry_pbrt_tpu_torch.interop import params_from_numpy
from curry_pbrt_tpu_torch.models import materials
from curry_pbrt_tpu_torch.models.materials import TexRef, eval_texref
from curry_pbrt_tpu_torch.ops.bsdf import luminance
from curry_pbrt_tpu_torch.ops.kernels import texel_grad as TG
from curry_pbrt_tpu_torch.ops.kernels.intersect_kernel import LAUNCHES
from curry_pbrt_tpu_torch.render import _render_chunk, pixel_arrays, plan_render
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file

REPO = Path(__file__).resolve().parents[1]
H, W, N = 16, 12, 4096


def _ids(kind: str, rng) -> torch.Tensor:
    """(N,) int64 flat texel ids: "hot" puts 60% of the rows on one texel
    (the (0, 0) corner every dead lane reads, as in a train step's later
    bounces), "random" spreads them."""
    ids = rng.integers(0, H * W, N)
    if kind == "hot":
        ids[rng.random(N) < 0.6] = (H - 1) * W
    return torch.from_numpy(ids)


def _img(rng, dtype=torch.float32):
    return torch.from_numpy(rng.random((H, W, 3))).to(dtype).requires_grad_(True)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().view(np.uint32)


@pytest.mark.parametrize("kind", ["hot", "random"])
def test_forward_is_the_plain_gather(kind):
    rng = np.random.default_rng(1)
    img, ids = _img(rng), _ids(kind, rng)
    out = TG.TexelGather.apply(img, ids)
    assert out.requires_grad
    assert np.array_equal(_bits(out), _bits(img.reshape(-1, 3)[ids]))


@pytest.mark.parametrize("kind,want_rgb", [("hot", True), ("random", True), ("hot", False)])
def test_cpu_backward_is_autograd_through_the_plain_gather(kind, want_rgb):
    rng = np.random.default_rng(2)
    img, ids = _img(rng), _ids(kind, rng)
    up = torch.from_numpy(rng.standard_normal((N, 3) if want_rgb else (N,)).astype(np.float32))
    got, want = [], []
    for gather, grads in ((TG.TexelGather.apply, got), (lambda t, i: t.reshape(-1, 3)[i], want)):
        img.grad = None
        texel = gather(img, ids)
        ((texel if want_rgb else luminance(texel)) * up).sum().backward()
        grads.append(img.grad.clone())
    assert got[0].shape == (H, W, 3)
    assert np.array_equal(_bits(got[0]), _bits(want[0]))
    counts = np.bincount(ids.numpy(), minlength=H * W)
    assert counts.max() > (0.5 * N if kind == "hot" else 0)


def test_backward_passes_gradcheck_in_float64():
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.random((4, 5, 3))).requires_grad_(True)
    ids = torch.from_numpy(rng.integers(0, 20, 64))
    ids[:40] = 7
    assert torch.autograd.gradcheck(lambda t: TG.TexelGather.apply(t, ids), (img,))


def test_texel_grad_is_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(4)
    ids = _ids("hot", rng).to(torch.int32)
    grad = torch.from_numpy(rng.standard_normal((N, 3)).astype(np.float32))
    before = LAUNCHES["texel_grad"]
    got = TG.texel_grad(ids, grad, H * W)
    assert np.array_equal(_bits(got), _bits(TG.texel_grad_plain(ids, grad, H * W)))
    assert LAUNCHES["texel_grad"] == before  # the plain version is no launch
    with pytest.raises(ValueError):
        TG.texel_grad(ids, grad[:, :2], H * W)


class _Entered:
    """TexelGather.apply, counting its calls."""

    def __init__(self):
        self.calls = 0
        self.real = TG.TexelGather.apply

    def __call__(self, *a):
        self.calls += 1
        return self.real(*a)


@pytest.mark.parametrize("mode,enters", [("grad", True), ("no_grad", False),
                                         ("inference_mode", False), ("leaf_no_grad", False)])
def test_eval_texref_enters_the_function_only_under_autograd(monkeypatch, mode, enters):
    rng = np.random.default_rng(5)
    entered = _Entered()
    monkeypatch.setattr(materials.TexelGather, "apply", entered)
    img = _img(rng).requires_grad_(mode != "leaf_no_grad")
    params = {"textures": {"t": img}}
    uv = torch.from_numpy(rng.random((N, 2)).astype(np.float32))
    ctx = {"grad": torch.enable_grad, "no_grad": torch.no_grad,
           "inference_mode": torch.inference_mode, "leaf_no_grad": torch.enable_grad}[mode]
    with ctx():
        for want_rgb in (True, False):
            out = eval_texref(TexRef.texture("t"), uv, params, 0, "Kd", want_rgb)
            assert out.requires_grad == enters
    assert entered.calls == (2 if enters else 0)


def test_a_rendered_texel_gradient_is_the_plain_gathers():
    """A cornell_tex chunk's texture gradient through the Function is the
    plain gather's, bit for bit (CPU)."""
    scene = compile_scene_file(REPO / "scenes" / "cornell_tex.pbrt",
                               overrides={"resolution": (16, 16), "spp": 2, "max_depth": 3})
    plan = plan_render(scene, device="cpu")
    grads, entered = [], _Entered()
    for route in ("function", "plain"):
        params = params_from_numpy(scene.init_params, "cpu")
        key = next(iter(params["textures"]))
        tex = params["textures"][key].requires_grad_(True)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(materials.TexelGather, "apply",
                       entered if route == "function" else lambda t, i: t.reshape(-1, 3)[i])
            img = _render_chunk(plan, params, *pixel_arrays(plan))[0]
            (img * img).sum().backward()
        grads.append(tex.grad)
    assert entered.calls >= 3  # a gather a bounce
    assert float(grads[0].abs().sum()) > 0
    assert np.array_equal(_bits(grads[0]), _bits(grads[1]))
