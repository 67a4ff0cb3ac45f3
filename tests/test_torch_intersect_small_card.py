"""The small-table walk of csrc/intersect_small.cu (K1, its stats variant
K1b, and K2) against the plain versions on the card, and the walk small
sphere tables take instead (the warp walk). Imports nothing of JAX, so that
it runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_intersect_small_card.py -q

Tolerance: none. t bit-equal to the plain version's, rows and the stats
(entered, improved) equal to the plain version's (each ray makes the same
tests in the same order), any-hit equal, dead lanes (t_max 0 or -1) no
hit. Without a card each test skips (marked cuda).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX
from curry_pbrt_tpu_torch.ops.kernels import intersect_kernel as TK
from curry_pbrt_tpu_torch.ops.kernels import sphere_kernel as TS
from curry_pbrt_tpu_torch.ops.kernels.aggregate import plan_tri_kernel
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file

FMAX = float(FLOAT_MAX)
SCENES = Path(__file__).resolve().parents[1] / "scenes"
BOX_C, SPREAD = (278.0, 274.0, 280.0), 280.0  # rays about the Cornell box, as chip_smoke.py
CTA = 256  # rays a CTA takes (csrc/intersect_small.cu THREADS) below 2^19 rays


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the walk of csrc/intersect_small.cu has no CPU mode")


def _cornell():
    scene = compile_scene_file(SCENES / "cornell_tex.pbrt")
    return plan_tri_kernel(scene.tris, np.asarray(scene.camera.camera_to_world)[:3, 3])


def _soup(n_clusters, seed):
    """block_t-8 tables of n_clusters clusters, one slab, no supers, with an
    empty cluster (invalid rows, a NaN box) in the middle of the walk."""
    rng = np.random.default_rng(seed)
    n_tris = n_clusters * 8 - 3
    p0 = rng.uniform(-8, 8, (n_tris, 3)).astype(np.float32)
    p1 = p0 + rng.normal(0, 1.2, (n_tris, 3)).astype(np.float32)
    p2 = p0 + rng.normal(0, 1.2, (n_tris, 3)).astype(np.float32)
    tab = TK.build_tri_tables(p0, p1, p2, np.arange(n_tris, dtype=np.int32), block_t=8,
                              view_origin=np.zeros(3), use_supers=False)
    c = tab.cluster_aabbs.shape[0] // 2
    pad = np.zeros((8, 16), np.float32)
    pad[:, 9] = -1.0
    tab.tris16 = np.concatenate([tab.tris16[:c * 8], pad, tab.tris16[c * 8:]])
    tab.cluster_aabbs = np.concatenate([tab.cluster_aabbs[:c], np.full((1, 8), np.nan, np.float32),
                                        tab.cluster_aabbs[c:]])
    tab.clusters_per_slab = tab.cluster_aabbs.shape[0]
    tab.slab_aabbs = tab.super_aabbs = TK.union_boxes(tab.cluster_aabbs[None])
    return tab


def _rays(n, seed, center=BOX_C, spread=SPREAD, live=None):
    """n rays from a box about `center` in random directions (every
    dominant axis, mixed within each CTA): every 7th lane dead, or,
    with `live`, that share of the lanes live at random (the dead ones t_max
    0 or -1)."""
    rng = np.random.default_rng(seed)
    o = (np.asarray(center, np.float32) + rng.uniform(-spread, spread, (n, 3))).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(rng.uniform(size=n) < 0.5, FMAX, spread).astype(np.float32)
    if live is None:
        t_max[::7] = 0.0
    else:
        dead = rng.uniform(size=n) >= live
        t_max[dead] = np.where(rng.uniform(size=int(dead.sum())) < 0.5, 0.0, -1.0)
    return tuple(torch.from_numpy(a).cuda() for a in (o, d, t_max))


def _hold(tab, rays):
    """The small walk (closest, with and without stats, and any) against the
    plain versions; counts its launches. Returns the closest hits."""
    dev = TK.DeviceTables(tab, "cuda")
    o, d, t_max = rays
    args = (o, d, t_max, dev.tris16, dev.caabb, dev.saabb, dev.slab_aabb)
    before = dict(TK.LAUNCHES)
    t_s, r_s = TK.tri_closest_hit_small(*args, **dev.kw)
    t_1, r_1, e_s, i_s = TK.tri_closest_hit_small(*args, **dev.kw, stats=True)
    h_s = TK.tri_any_hit_small(*args, **dev.kw)
    torch.cuda.synchronize()
    n = o.shape[0]
    assert t_s.shape == r_s.shape == h_s.shape == (n,)
    if n:
        for key in ("tri_closest_small", "tri_closest_stats_small", "tri_any_small"):
            assert TK.LAUNCHES[key] == before[key] + 1
        assert TK.LAUNCHES["tri_closest"] == before["tri_closest"]
    t_p, r_p, e_p, i_p = TK.tri_closest_hit_plain(*args, **dev.kw, stats=True)
    h_p = TK.tri_any_hit_plain(*args, **dev.kw)
    for t, r in ((t_s, r_s), (t_1, r_1)):
        assert torch.equal(t.view(torch.int32), t_p.view(torch.int32))
        assert torch.equal(r, r_p)
    assert torch.equal(e_s, e_p) and torch.equal(i_s, i_p)
    assert torch.equal(h_s, h_p)
    assert not (r_s[~(t_max > 0)] >= 0).any() and not h_s[~(t_max > 0)].any()
    return int((r_p >= 0).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 31, CTA - 1, CTA + 1, 4097, (1 << 20) + 333],
                         ids=["none", "one", "31", "cta-1", "cta+1", "4097", "1M+333-scan4"])
def test_small_walk_at_ragged_sizes(card, n):
    """No ray, one, and counts that are not a multiple of a warp or a CTA;
    past 2^20 rays each thread reads 4 rays in the partition (1,024-ray
    CTAs), the last CTA ragged."""
    hits = _hold(_cornell(), _rays(n, 100 + n % 97))
    assert n < 100 or hits > n // 4


@pytest.mark.cuda
@pytest.mark.parametrize("live", [0.0, 0.1, 1.0], ids=["all-dead", "90pct-dead", "all-live"])
def test_small_walk_at_live_shares(card, live):
    hits = _hold(_cornell(), _rays(50_001, 7, live=live))
    assert (hits == 0) if live == 0.0 else hits > 50_001 * live / 4


@pytest.mark.cuda
def test_small_walk_with_few_live_rays_a_cta(card):
    """~1.3% live lanes (a headline final hit's share): a CTA's few live
    rays of all three axes share one warp, which walks them with the axis
    at run time."""
    hits = _hold(_cornell(), _rays(200_003, 13, live=0.013))
    assert hits > 200


@pytest.mark.cuda
def test_small_walk_mixes_axes_within_a_cta(card):
    """One CTA of 256 rays whose dominant axes (and signs) cycle lane by
    lane, so every warp's rays are regrouped into three bins, two warps
    straddling a bin boundary."""
    rng = np.random.default_rng(8)
    d = rng.normal(0, 0.2, (CTA, 3)).astype(np.float32)
    axis = np.arange(CTA) % 6
    d[np.arange(CTA), axis // 2] = np.where(axis % 2, -1.0, 1.0)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (np.asarray(BOX_C, np.float32) + rng.uniform(-200, 200, (CTA, 3))).astype(np.float32)
    t_max = np.full(CTA, FMAX, np.float32)
    rays = tuple(torch.from_numpy(a).cuda() for a in (o, d, t_max))
    assert _hold(_cornell(), rays) > CTA // 2


@pytest.mark.cuda
@pytest.mark.parametrize("n_clusters", [3, 40, 64, 97])
def test_small_walk_on_soups(card, n_clusters):
    """8-row soups up to the largest table the small-scene plan builds (64
    clusters) and the largest the walk stages (98 with the NaN cluster)."""
    tab = _soup(n_clusters, 10 + n_clusters)
    hits = _hold(tab, _rays(20_000, 30 + n_clusters, (0, 0, 0), 9.0))
    assert hits > 100


@pytest.mark.cuda
def test_small_walk_at_t_max_ties(card):
    """t_max at each ray's exact closest t: the first-hit-at-t_max rule."""
    tab = _cornell()
    dev = TK.DeviceTables(tab, "cuda")
    o, d, t_max = _rays(30_000, 9)
    t_p, _ = TK.tri_closest_hit_plain(o, d, t_max, dev.tris16, dev.caabb, dev.saabb,
                                      dev.slab_aabb, **dev.kw)
    assert _hold(tab, (o, d, torch.where(t_p < 1e30, t_p, t_max))) > 10_000


@pytest.mark.cuda
def test_the_plan_refuses_tables_the_small_walk_cannot_stage(card):
    """On the card the planned wrappers raise for block_t-8 tables the small
    walk cannot stage (no quiet fallback to another walk)."""
    rng = np.random.default_rng(11)
    p = [rng.uniform(-8, 8, (900, 3)).astype(np.float32) for _ in range(3)]
    big = TK.DeviceTables(TK.build_tri_tables(*p, np.arange(900, dtype=np.int32), block_t=8,
                                              use_supers=False), "cuda")
    o, d, t_max = _rays(64, 12, (0, 0, 0), 9.0)
    assert big.plan == "small"
    with pytest.raises(ValueError, match="bytes"):
        big.closest(o, d, t_max)
    with pytest.raises(ValueError, match="bytes"):
        big.any_hit(o, d, t_max)


def _sphere_soup(n, seed, **kw):
    """Block_s-8 sphere tables: n randomly rotated, anisotropically scaled
    spheres in a 24-unit box."""
    rng = np.random.default_rng(seed)
    o2w = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        o2w[i, :3, :3] = q @ np.diag(rng.uniform(0.7, 1.4, 3))
        o2w[i, :3, 3] = rng.uniform(-12, 12, 3)
    return TS.build_sphere_tables(np.linalg.inv(o2w).astype(np.float32), o2w,
                                  rng.uniform(0.2, 1.2, n).astype(np.float32),
                                  np.arange(n, dtype=np.int32), block_s=8,
                                  view_origin=np.zeros(3), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, dict(clusters_per_slab=16, use_supers=True)],
                         ids=["one-slab", "slabs-supers"])
def test_sphere_tables_of_8_rows_take_the_warp_walk(card, kw):
    """The launch plan sends sphere tables of 8 rows a cluster to the warp
    walk (the small walk has no sphere test): t bit-equal to the plain
    version's, sign included, rows equal up to exact-t ties, any-hit
    equal, dead lanes no hit; also with t_max at each ray's own closest t
    (the first-hit-at-t_max rule)."""
    tab = _sphere_soup(600, 21, **kw)
    assert tab.block_s == 8 and TK.launch_plan(tab.block_s, spheres=True) == "warp"
    if kw:
        assert tab.use_supers and tab.slab_aabbs.shape[0] > 1
    dev = TS.DeviceSphereTables(tab, "cuda")
    assert dev.plan == "warp"
    o, d, t_max = _rays(50_001, 23, center=(0, 0, 0), spread=14.0)
    tables = (dev.sph16, dev.caabb, dev.saabb, dev.slab_aabb)
    t_p, _ = TS.sphere_closest_hit_plain(o, d, t_max, *tables, **dev.kw)
    for tm in (t_max, torch.where(t_p < 1e30, t_p, t_max)):
        before = dict(TK.LAUNCHES)
        t_k, r_k = TS.sphere_closest_hit_tables(o, d, tm, *tables, **dev.kw)
        h_k = TS.sphere_any_hit_tables(o, d, tm, *tables, **dev.kw)
        torch.cuda.synchronize()
        for key in ("sphere_closest", "sphere_any"):
            assert TK.LAUNCHES[key] == before[key] + 1
        t_p, r_p = TS.sphere_closest_hit_plain(o, d, tm, *tables, **dev.kw)
        h_p = TS.sphere_any_hit_plain(o, d, tm, *tables, **dev.kw)
        assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
        assert torch.equal(r_k >= 0, r_p >= 0) and int((r_p >= 0).sum()) > 5_000
        for i in torch.nonzero(r_k != r_p).squeeze(1).tolist():  # exact-t ties only
            rows = dev.sph16[torch.stack([r_k[i], r_p[i]]).long()]
            t_rows = TS._sphere_tile_test(rows, o[i:i + 1], d[i:i + 1], tm[i:i + 1])[0]
            assert t_rows[0] == t_rows[1] == t_k[i]
        assert torch.equal(h_k, h_p)
        assert not (r_k[~(tm > 0)] >= 0).any() and not h_k[~(tm > 0)].any()
