"""The texel gather's backward on the card (csrc/texel_grad.cu through
ops/kernels/texel_grad.texel_grad). Imports nothing of JAX, so that it runs
where only the port is installed:

    python -m pytest --noconftest tests/test_torch_texel_grad_card.py -q

At a train step's shapes (4,194,304 rows into the 128 x 128 texture of
cornell_tex, 26% and 54% of them on one texel, as in the step's later
bounces) and into a 1024 x 1024 table: the kernel is bit-equal to itself
over two runs, and every texel's sum is within 1e-5 x Σ|terms| of a float64
sum of the same terms. The bound is that of a float32 sum in a fixed order
other than the serial one: the kernel adds a segment's rows in tiles,
through a scan and carries, and PyTorch's index_put_(accumulate=True) adds
them in series; each reassociation of float32 sums moves a texel by a few
float32 roundings of its terms' magnitude (a gradient's terms have both
signs, so a sum's roundings do not pile up). index_put_ on the card meets
the same bound. Then the edges (no rows, one texel, a segment over many
tiles, ragged ends) and a rendered chunk's texture gradient through the
Function against the plain gather's. Without a card each test skips
(marked cuda).
"""

from pathlib import Path

import pytest
import torch

from curry_pbrt_tpu_torch.models import materials
from curry_pbrt_tpu_torch.ops.kernels import texel_grad as TG
from curry_pbrt_tpu_torch.ops.kernels.intersect_kernel import LAUNCHES

REPO = Path(__file__).resolve().parents[1]
ROWS = 4_194_304  # a train step's gather: 65,536 pixels x 64 spp
TILE = 2048  # sorted rows a CTA of the kernel (csrc/texel_grad.cu TILE)
HOT = 16_256  # the texel uv = (0, 0) maps to in a 128 x 128 texture
RTOL = 1e-5

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/texel_grad.cu has no CPU mode")
    return torch.device("cuda")


def _rows(n, n_texels, hot_share, dev, seed):
    """(ids (n,) int32, grad (n, 3) f32): ids uniform over the texels but
    hot_share of them on HOT, standard normal gradient rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, n_texels, (n,), generator=g, device=dev, dtype=torch.int32)
    hot = torch.rand((n,), generator=g, device=dev) < hot_share
    ids[hot] = HOT
    return ids, torch.randn((n, 3), generator=g, device=dev)


def _within(got, ids, grad, n_texels):
    """Worst |got − Σ| / Σ|terms| over the texels (float64 sums)."""
    idx = ids.long()
    exact = torch.zeros((n_texels, 3), dtype=torch.float64, device=ids.device)
    exact.index_add_(0, idx, grad.double())
    mag = torch.zeros_like(exact).index_add_(0, idx, grad.double().abs())
    err = (got.double() - exact).abs()
    assert bool((err <= RTOL * mag).all()), float((err / mag.clamp(min=1e-300)).max())
    return float((err / mag.clamp(min=1e-300)).max())


@pytest.mark.parametrize("n_texels,hot_share", [(128 * 128, 0.26), (128 * 128, 0.54),
                                                (1024 * 1024, 0.54)])
def test_the_segment_sum_at_the_steps_shapes(card, n_texels, hot_share):
    ids, grad = _rows(ROWS, n_texels, hot_share, card, seed=int(hot_share * 100) + n_texels)
    before = LAUNCHES["texel_grad"]
    a = TG.texel_grad(ids, grad, n_texels)
    b = TG.texel_grad(ids, grad, n_texels)
    torch.cuda.synchronize()
    assert LAUNCHES["texel_grad"] == before + 2
    assert a.shape == (n_texels, 3) and a.dtype == torch.float32
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    share = float((ids == HOT).float().mean())
    assert abs(share - hot_share) < 0.01
    _within(a, ids, grad, n_texels)
    _within(TG.texel_grad_plain(ids, grad, n_texels), ids, grad, n_texels)  # index_put_


@pytest.mark.parametrize("case", ["empty", "one row", "one texel", "one tile", "tile + 1",
                                  "many tiles, few texels", "ragged"])
def test_the_edges(card, case):
    n_texels = 64
    g = torch.Generator(device=card).manual_seed(7)
    n = {"empty": 0, "one row": 1, "one texel": 3 * TILE + 17, "one tile": TILE,
         "tile + 1": TILE + 1, "many tiles, few texels": 1500 * TILE,
         "ragged": 1025 * TILE + 3}[case]
    ids = torch.randint(0, n_texels, (n,), generator=g, device=card, dtype=torch.int32)
    if case == "one texel":
        ids.fill_(5)
    if case == "many tiles, few texels":  # runs of ~375 tiles each, three levels
        ids = torch.randint(0, 4, (n,), generator=g, device=card, dtype=torch.int32)
    grad = torch.randn((n, 3), generator=g, device=card)
    out = TG.texel_grad(ids, grad, n_texels)
    untouched = torch.ones(n_texels, dtype=torch.bool, device=card)
    untouched[ids.long()] = False
    assert bool((out[untouched] == 0).all())
    if n:
        _within(out, ids, grad, n_texels)
    # integer-valued rows sum exactly in any order: every row counted once
    ints = torch.randint(-8, 9, (n, 3), generator=g, device=card).float()
    exact = torch.zeros((n_texels, 3), dtype=torch.float64, device=card)
    exact.index_add_(0, ids.long(), ints.double())
    assert torch.equal(TG.texel_grad(ids, ints, n_texels).double(), exact)


def test_the_kernel_refuses_what_it_does_not_take(card):
    ids = torch.zeros((8,), dtype=torch.int64, device=card)
    with pytest.raises(ValueError):
        TG.texel_grad(ids, torch.zeros((8, 3), device=card), 4)
    with pytest.raises(ValueError):
        TG.texel_grad(ids.int(), torch.zeros((8, 3), dtype=torch.float64, device=card), 4)


def test_a_rendered_texel_gradient_on_the_card(card, monkeypatch):
    """cornell_tex at 64², 8 spp, depth 5: the texture gradient through the
    Function (one launch a bounce) is within the bound of the plain
    gather's (index_put_), and bit-equal over two backward passes."""
    from curry_pbrt_tpu_torch.interop import params_from_numpy
    from curry_pbrt_tpu_torch.render import _render_chunk, pixel_arrays, plan_render
    from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file

    scene = compile_scene_file(REPO / "scenes" / "cornell_tex.pbrt",
                               overrides={"resolution": (64, 64), "spp": 8, "max_depth": 5})
    plan = plan_render(scene, device="cuda")
    po, px = pixel_arrays(plan)

    def texel_grad():
        params = params_from_numpy(scene.init_params, "cuda")
        tex = params["textures"][next(iter(params["textures"]))].requires_grad_(True)
        img = _render_chunk(plan, params, po, px)[0]
        (img * img).sum().backward()
        return tex.grad

    before = LAUNCHES["texel_grad"]
    a, b = texel_grad(), texel_grad()
    assert LAUNCHES["texel_grad"] - before == 2 * 5
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    monkeypatch.setattr(materials.TexelGather, "apply", lambda t, i: t.reshape(-1, 3)[i])
    plain = texel_grad()
    assert LAUNCHES["texel_grad"] - before == 2 * 5
    scale = float(plain.abs().max())
    assert scale > 0
    assert float((a - plain).abs().max()) <= 1e-4 * scale
