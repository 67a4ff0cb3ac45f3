"""The group kernel K4 of csrc/intersect_group.cu (closest and any hit) and
its baseline (`tri_*_hit_group_rule`) against their plain version on the
card. Imports nothing of JAX, so that it runs where only the port is
installed:

    python -m pytest --noconftest tests/test_torch_intersect_group_card.py -q

Tolerance: none. t bit-equal to the plain version's (the group rule), rows
equal to its rows (no tie allowance: the gate skips only clusters that hold
no hit the group rule accepts), any-hit equal, dead lanes (t_max 0 or -1)
no hit, two launches bit-equal, the baseline equal to K4. Without a card
each test skips (marked cuda).
"""

import numpy as np
import pytest
import torch

from curry_pbrt_tpu_torch.ops.kernels import intersect_group as TG
from curry_pbrt_tpu_torch.ops.kernels import intersect_kernel as TK
from curry_pbrt_tpu_torch.tools.probe_group_kernel import coplanar_batch, face_tie_batch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels of csrc/intersect_group.cu have no CPU mode")


def _soup(n_tris, seed, block_t=128, cps=128):
    """A triangle soup in K4's tables; at block_t 32 and 16 clusters a slab,
    several slabs and NaN padding clusters."""
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-8, 8, (n_tris, 3)).astype(np.float32)
    p1 = p0 + rng.normal(0, 1.0, (n_tris, 3)).astype(np.float32)
    p2 = p0 + rng.normal(0, 1.0, (n_tris, 3)).astype(np.float32)
    return TG.group_tables(p0, p1, p2, np.arange(n_tris, dtype=np.int32),
                           view_origin=np.zeros(3), block_t=block_t, clusters_per_slab=cps)


def _rays(n, seed, live=None):
    """n rays from a box about the soup: every 7th lane dead, or, with
    `live`, that share of the lanes live at random (the dead ones t_max 0
    or -1)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-9, 9, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(rng.uniform(size=n) < 0.5, 1e30, 9.0).astype(np.float32)
    if live is None:
        t_max[::7] = 0.0
    else:
        dead = rng.uniform(size=n) >= live
        t_max[dead] = np.where(rng.uniform(size=int(dead.sum())) < 0.5, 0.0, -1.0)
    return tuple(torch.from_numpy(a).cuda() for a in (o, d, t_max))


def _hold(tab, rays):
    """K4 (twice) and its baseline against the plain version; counts the
    launches. Returns the closest hits."""
    dev = TK.DeviceTables(tab, "cuda")
    kw = TG.group_kw(dev)
    o, d, t_max = rays
    args = (o, d, t_max, dev.tris16, dev.caabb, dev.saabb, dev.slab_aabb)
    before = dict(TK.LAUNCHES)
    t_4, r_4 = TG.tri_closest_hit_groups(*args, **kw)
    h_4 = TG.tri_any_hit_groups(*args, **kw)
    t_2, r_2 = TG.tri_closest_hit_groups(*args, **kw)
    h_2 = TG.tri_any_hit_groups(*args, **kw)
    t_b, r_b = TG.tri_closest_hit_group_rule(*args, **kw)
    h_b = TG.tri_any_hit_group_rule(*args, **kw)
    torch.cuda.synchronize()
    n = o.shape[0]
    assert t_4.shape == r_4.shape == h_4.shape == (n,)
    if n:
        for key, k in (("tri_closest_group", 2), ("tri_any_group", 2),
                       ("tri_closest_group_rule", 1), ("tri_any_group_rule", 1)):
            assert TK.LAUNCHES[key] == before[key] + k
    t_p, r_p = TG.tri_closest_hit_groups_plain(*args, **kw)
    h_p = TG.tri_any_hit_groups_plain(*args, **kw)
    for t, r, h in ((t_4, r_4, h_4), (t_2, r_2, h_2), (t_b, r_b, h_b)):
        assert torch.equal(t.view(torch.int32), t_p.view(torch.int32))
        assert torch.equal(r, r_p)
        assert torch.equal(h, h_p)
    assert not (r_4[~(t_max > 0)] >= 0).any() and not h_4[~(t_max > 0)].any()
    return int((r_p >= 0).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 7, 9, 31, 4097, (1 << 20) + 333],
                         ids=["none", "one", "7", "9", "31", "4097", "1M+333"])
def test_group_kernel_at_ragged_sizes(card, n):
    """No ray, one, and counts that are not a multiple of a group (8) or a
    block (4 groups): the tail group is padded with dead rays."""
    hits = _hold(_soup(5000, 1), _rays(n, 100 + n % 97))
    assert n < 100 or hits > n // 8


@pytest.mark.cuda
@pytest.mark.parametrize("live", [0.0, 0.1, 1.0], ids=["all-dead", "90pct-dead", "all-live"])
def test_group_kernel_at_live_shares(card, live):
    hits = _hold(_soup(5000, 2), _rays(50_001, 7, live=live))
    assert (hits == 0) if live == 0.0 else hits > 50_001 * live / 8


@pytest.mark.cuda
def test_group_kernel_at_t_max_ties(card):
    """t_max at each ray's own closest t (the first-hit-at-t_max rule
    decides every hit ray), and the face-tie batch: first hits at exactly
    t_max in a cluster whose box_near is t_max, which a strict gate loses."""
    tab = _soup(5000, 3)
    dev = TK.DeviceTables(tab, "cuda")
    o, d, t_max = _rays(30_000, 9)
    t_p, _ = TG.tri_closest_hit_groups_plain(o, d, t_max, dev.tris16, dev.caabb, dev.saabb,
                                             dev.slab_aabb, **TG.group_kw(dev))
    assert _hold(tab, (o, d, torch.where(t_p < 1e30, t_p, t_max))) > 5_000
    ftab, rays, tie = face_tie_batch(n_rays=30_000)
    rays = tuple(torch.from_numpy(a).cuda() for a in rays)
    assert _hold(ftab, rays) > 5_000
    fdev = TK.DeviceTables(ftab, "cuda")
    t_4, r_4 = TG.tri_closest_hit_groups(*rays, fdev.tris16, fdev.caabb, fdev.saabb,
                                         fdev.slab_aabb, **TG.group_kw(fdev))
    tie = torch.as_tensor(tie, device="cuda")
    assert bool((t_4[tie] == 4.0).all()) and bool((r_4[tie] >= 0).all())


@pytest.mark.cuda
def test_group_kernel_on_coplanar_triangles(card):
    """Overlapping coplanar triangles over clusters (the probe's coplanar
    batch): hits that fall just below a later cluster's box_near, which the
    gate's slack keeps."""
    tab, rays = coplanar_batch(n_quads=3000, n_rays=30_000, seed=3)
    assert _hold(tab, tuple(torch.from_numpy(a).cuda() for a in rays)) > 15_000


@pytest.mark.cuda
@pytest.mark.parametrize("block_t,cps", [(32, 16), (256, 8)], ids=["multi-slab-nan", "block-256"])
def test_group_kernel_on_soups(card, block_t, cps):
    """Several slabs with NaN padding clusters (32-row clusters, 16 a slab),
    and 256-row clusters, which the kernel takes as two 128-row chunks."""
    tab = _soup(1900, 4, block_t, cps)
    if cps == 16:
        assert tab.n_slabs > 1 and np.isnan(tab.cluster_aabbs[:, 0]).any()
    assert _hold(tab, _rays(20_000, 5)) > 1_000


@pytest.mark.cuda
def test_group_kernel_never_syncs_the_host(card):
    """The wrappers queue their launches without a host synchronisation."""
    dev = TK.DeviceTables(_soup(5000, 6), "cuda")
    kw = TG.group_kw(dev)
    args = _rays(4097, 11) + (dev.tris16, dev.caabb, dev.saabb, dev.slab_aabb)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn in (TG.tri_closest_hit_groups, TG.tri_any_hit_groups,
                   TG.tri_closest_hit_group_rule, TG.tri_any_hit_group_rule):
            fn(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
