"""The BVH walk of csrc/bvh_walk.cu against its plain version (ops/bvh.py
bvh_traverse) on the card: the live-ray walk (bvh_closest / bvh_any).
Imports nothing of JAX, so that it runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_bvh_card.py -q

Tolerance: none. t bit-equal (sign bit included), hit masks and any-hit
equal, refs equal up to exact-t ties (both prims give the walk's t), dead
lanes (t_max 0) no hit. Two launches of the live-ray walk are bit-equal
(the order of its live list varies; no result depends on it), and it makes
no host sync. Without a card each test skips (marked cuda).
"""

import numpy as np
import pytest
import torch

from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX
from curry_pbrt_tpu_torch.ops import bvh as PB
from curry_pbrt_tpu_torch.ops import intersect as isect
from curry_pbrt_tpu_torch.ops.kernels import bvh_kernel as BK
from curry_pbrt_tpu_torch.ops.kernels import intersect_kernel as TK


class _Soup:
    """n_tris small triangles and n_sph rotated, anisotropically scaled
    spheres in a 16-unit box (the compiler's tris / spheres arrays)."""

    def __init__(self, n_tris, n_sph, seed):
        rng = np.random.default_rng(seed)
        p0 = rng.uniform(-8, 8, (n_tris, 3)).astype(np.float32)
        p1 = p0 + rng.normal(0, 0.6, (n_tris, 3)).astype(np.float32)
        p2 = p0 + rng.normal(0, 0.6, (n_tris, 3)).astype(np.float32)
        self.tris = isect.TriangleArrays(p0, p1, p2, np.arange(n_tris, dtype=np.int32))
        o2w = np.tile(np.eye(4, dtype=np.float32), (n_sph, 1, 1))
        for i in range(n_sph):
            q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
            o2w[i, :3, :3] = q @ np.diag(rng.uniform(0.7, 1.4, 3))
            o2w[i, :3, 3] = rng.uniform(-8, 8, 3)
        self.spheres = isect.SphereArrays(o2w, np.linalg.inv(o2w).astype(np.float32),
                                          rng.uniform(0.2, 0.9, n_sph).astype(np.float32),
                                          np.arange(n_sph, dtype=np.int32))


def _rays(n, seed, live=None):
    """n rays in the soup's box: every 7th lane dead (t_max 0), or, with
    `live`, that share of the lanes live at random (the dead ones t_max 0
    or -1)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-9, 9, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(rng.uniform(size=n) < 0.5, FLOAT_MAX, 9.0).astype(np.float32)
    if live is None:
        t_max[::7] = 0.0
    else:
        dead = rng.uniform(size=n) >= live
        t_max[dead] = np.where(rng.uniform(size=int(dead.sum())) < 0.5, 0.0, -1.0)
    return tuple(torch.from_numpy(a).cuda() for a in (o, d, t_max))


def _soup_bvh(n_tris=3000, n_sph=64):
    soup = _Soup(n_tris, n_sph, seed=n_tris + n_sph)
    return PB.device_bvh(PB.build_flat_bvh(soup), soup.tris, soup.spheres, "cuda")


def _hold(bvh, rays, t_k, r_k, h_k):
    """(t, ref) and any-hit against the plain version: t bit-equal, masks
    and any-hit equal, refs equal up to exact-t ties, dead lanes no hit."""
    o, d, t_max = rays
    t_p, r_p = PB.bvh_traverse(bvh, o, d, t_max)
    h_p = PB.bvh_traverse(bvh, o, d, t_max, any_hit=True)[1] >= 0
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(h_k, h_p)
    assert torch.equal(r_k >= 0, r_p >= 0)
    assert not (r_k[~(t_max > 0)] >= 0).any()
    diff = r_k != r_p
    if diff.any():  # only where both prims give the same t
        sh = tuple(x[diff] for x in isect.ray_shear(d))
        tk, _ = PB._leaf_prim_test(bvh, r_k[diff], o[diff], d[diff], sh, t_max[diff])
        tp, _ = PB._leaf_prim_test(bvh, r_p[diff], o[diff], d[diff], sh, t_max[diff])
        assert torch.equal(tk, tp) and torch.equal(tk, t_k[diff])
    return int((r_p >= 0).sum())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the walk of csrc/bvh_walk.cu has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("n_tris,n_sph", [(3000, 64), (0, 300), (2000, 0)])
def test_walk_matches_plain_on_the_card(card, n_tris, n_sph):
    soup = _Soup(n_tris, n_sph, seed=n_tris + n_sph)
    bvh = PB.device_bvh(PB.build_flat_bvh(soup), soup.tris, soup.spheres, "cuda")
    o, d, t_max = _rays(1 << 14, 6)
    before = dict(TK.LAUNCHES)
    t_k, r_k = BK.bvh_closest(bvh, o, d, t_max)
    h_k = BK.bvh_any(bvh, o, d, t_max)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["bvh_closest"] == before["bvh_closest"] + 1
    assert TK.LAUNCHES["bvh_any"] == before["bvh_any"] + 1
    assert _hold(bvh, (o, d, t_max), t_k, r_k, h_k) > 1000
    assert not (r_k[::7] >= 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("live", [0.0, 0.027, 1.0])
def test_live_walk_at_live_shares(card, live):
    """0%, 2.7% (a mesh bounce 2's share) and 100% live lanes at 2^16 rays."""
    bvh = _soup_bvh()
    rays = _rays(1 << 16, 7, live=live)
    t_k, r_k = BK.bvh_closest(bvh, *rays)
    h_k = BK.bvh_any(bvh, *rays)
    torch.cuda.synchronize()
    hits = _hold(bvh, rays, t_k, r_k, h_k)
    assert (hits == 0) if live == 0.0 else hits > 100 * live


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 31, 1000, 4097])
def test_live_walk_at_ragged_sizes(card, n):
    """No ray, and counts that are not a multiple of the block or a warp."""
    bvh = _soup_bvh()
    rays = _rays(n, 8)
    t_k, r_k = BK.bvh_closest(bvh, *rays)
    h_k = BK.bvh_any(bvh, *rays)
    torch.cuda.synchronize()
    assert t_k.shape == (n,) and r_k.shape == (n,) and h_k.shape == (n,)
    _hold(bvh, rays, t_k, r_k, h_k)


@pytest.mark.cuda
def test_live_walk_strides_past_its_grid(card):
    """2^20 live rays, more than the walk's grid has threads (an H100's 132
    SMs hold at most 16 blocks of 128 threads each: 270,336), so each
    thread strides through several entries of the live list."""
    bvh = _soup_bvh()
    rays = _rays(1 << 20, 9, live=1.0)
    t_k, r_k = BK.bvh_closest(bvh, *rays)
    h_k = BK.bvh_any(bvh, *rays)
    torch.cuda.synchronize()
    assert _hold(bvh, rays, t_k, r_k, h_k) > 1 << 16


@pytest.mark.cuda
def test_live_walk_twice_bit_equal(card):
    """The live list's order varies from launch to launch; the results do
    not."""
    bvh = _soup_bvh()
    rays = _rays(1 << 16, 10, live=0.3)
    first = BK.bvh_closest(bvh, *rays), BK.bvh_any(bvh, *rays)
    second = BK.bvh_closest(bvh, *rays), BK.bvh_any(bvh, *rays)
    torch.cuda.synchronize()
    assert torch.equal(first[0][0].view(torch.int32), second[0][0].view(torch.int32))
    assert torch.equal(first[0][1], second[0][1]) and torch.equal(first[1], second[1])


@pytest.mark.cuda
def test_live_walk_makes_no_host_sync(card):
    """bvh_closest / bvh_any queue their work and return: no .item(), no
    nonzero, no copy to the host."""
    bvh = _soup_bvh()
    rays = _rays(1 << 14, 11, live=0.5)
    BK.bvh_closest(bvh, *rays)  # builds and loads the library first
    torch.cuda.synchronize()
    before = dict(TK.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        t_k, r_k = BK.bvh_closest(bvh, *rays)
        h_k = BK.bvh_any(bvh, *rays)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert TK.LAUNCHES["bvh_closest"] == before["bvh_closest"] + 1
    assert TK.LAUNCHES["bvh_any"] == before["bvh_any"] + 1
    _hold(bvh, rays, t_k, r_k, h_k)
