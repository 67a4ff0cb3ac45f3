"""The port's group-granular traversal (K4), plain PyTorch versions, against
the JAX package's `tri_closest_hit_groups` / `tri_any_hit_groups` in
interpret mode (curry_pbrt_tpu/ops/pallas/intersect_group.py), and against
the port's own K1 / K2 plain versions.

Tolerance against JAX: t within rtol 1e-6 plus atol 1e-6, as the K1 parity
test states it (tests/test_torch_intersect_kernel.py): XLA's CPU lowering
contracts a*b+c into FMAs, the port rounds every op separately. Prims and
any-hit results are equal. Against the port's K1 the t values are
bit-equal: the same per-pair arithmetic, and the conservative box test makes
the group's extra tile tests find nothing new.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from curry_pbrt_tpu.ops.pallas import intersect_group as JG
from curry_pbrt_tpu.ops.pallas import intersect_kernel as JK
from curry_pbrt_tpu_torch.ops.kernels import intersect_group as TG
from curry_pbrt_tpu_torch.ops.kernels import intersect_kernel as TK

RTOL, ATOL = 1e-6, 1e-6


def _scene(seed, n_rays, n_tris, spread):
    """tests/test_pallas_intersect.py's _random_scene, with every 7th lane
    dead (t_max 0)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
    p1 = base + rng.normal(0, 0.7, (n_tris, 3)).astype(np.float32)
    p2 = base + rng.normal(0, 0.7, (n_tris, 3)).astype(np.float32)
    o = rng.uniform(-4, 4, (n_rays, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full((n_rays,), 100.0, np.float32)
    t_max[::7] = 0.0
    return o, d, t_max, base, p1, p2


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _tabs(tab):
    return (tab.tris16, tab.cluster_aabbs, tab.super_aabbs, tab.slab_aabbs)


def _prims(tab, rows):
    return np.where(rows >= 0, tab.prim[np.clip(rows, 0, len(tab.prim) - 1)], -1)


@pytest.mark.parametrize("block_t,cps", [(128, 8), (32, 16)], ids=["one-slab", "multi-slab"])
def test_plain_matches_jax_group_kernel(block_t, cps):
    """At the JAX test's own size (tests/test_pallas_intersect.py:115-162:
    256 rays, 900 tris): its 128-tri clusters in one slab, and 32-tri
    clusters in two slabs of 16 with supers."""
    o, d, t_max, p0, p1, p2 = _scene(17, 256, 900, spread=6.0)
    prim = np.arange(900, dtype=np.int32)
    tab = TG.group_tables(p0, p1, p2, prim, view_origin=np.zeros(3), block_t=block_t,
                          clusters_per_slab=cps)
    jtab = JK.build_tri_tables(p0, p1, p2, prim, block_t=block_t, view_origin=np.zeros(3),
                               clusters_per_slab=cps, use_supers=True)
    np.testing.assert_array_equal(tab.tris16, jtab.tris16)
    kw = dict(block_t=block_t, clusters_per_slab=tab.clusters_per_slab)
    jargs = (jnp.asarray(JG.tris_lane_major(jtab)), jnp.asarray(jtab.cluster_aabbs),
             jnp.asarray(jtab.super_aabbs), jnp.asarray(jtab.slab_aabbs))
    jt, ji = JG.tri_closest_hit_groups(*map(jnp.asarray, (o, d, t_max)), *jargs, interpret=True,
                                       block_r=256, **kw)
    jh = JG.tri_any_hit_groups(*map(jnp.asarray, (o, d, t_max * 0.999)), *jargs, interpret=True,
                               block_r=256, **kw)
    tt, ti = TG.tri_closest_hit_groups(*_t(o, d, t_max, *_tabs(tab)), **kw)
    th = TG.tri_any_hit_groups(*_t(o, d, t_max * 0.999, *_tabs(tab)), **kw)
    jt, ji, jh = map(np.asarray, (jt, ji, jh))
    tt, ti, th = tt.numpy(), ti.numpy(), th.numpy()
    hit = ti >= 0
    assert hit.sum() > 20 and (tab.n_slabs > 1) == (cps == 16)
    np.testing.assert_array_equal(ji >= 0, hit)
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(_prims(tab, ti), _prims(jtab, ji))
    np.testing.assert_array_equal(th, jh)
    assert not th[t_max == 0].any() and not hit[t_max == 0].any()


@pytest.mark.parametrize("n_rays", [200, 203], ids=["whole-groups", "tail-group"])
def test_plain_bit_equal_to_k1_on_a_multislab_soup(n_rays):
    """K4 plain vs K1 / K2 plain on a 1.9k-tri soup in several slabs with
    supers; 203 rays leave a tail group of 3 (padded with dead rays)."""
    o, d, t_max, p0, p1, p2 = _scene(21, n_rays, 1900, spread=6.0)
    prim = np.arange(1900, dtype=np.int32)
    k1 = TK.build_tri_tables(p0, p1, p2, prim, block_t=64, view_origin=np.zeros(3),
                             clusters_per_slab=16, use_supers=True)
    k4 = TG.group_tables(p0, p1, p2, prim, view_origin=np.zeros(3), block_t=32,
                         clusters_per_slab=16)
    assert k4.n_slabs > 1 and k1.n_slabs > 1 and k4.use_supers
    k1_kw = dict(block_t=64, clusters_per_slab=k1.clusters_per_slab, use_supers=True)
    k4_kw = dict(block_t=32, clusters_per_slab=k4.clusters_per_slab)
    t1, r1 = TK.tri_closest_hit_tables(*_t(o, d, t_max, *_tabs(k1)), **k1_kw)
    t4, r4, entered, improved = TG.tri_closest_hit_groups_plain(
        *_t(o, d, t_max, *_tabs(k4)), **k4_kw, stats=True)
    assert t4.shape == (n_rays,) and (r1 >= 0).sum() > 20
    assert torch.equal(t1, t4)
    np.testing.assert_array_equal(_prims(k1, r1.numpy()), _prims(k4, r4.numpy()))
    assert torch.equal(TG.tri_closest_hit_groups(*_t(o, d, t_max, *_tabs(k4)), **k4_kw)[0], t4)
    # every ray of a group counts the same tiles; improved tiles are entered ones
    whole = n_rays // 8 * 8
    groups = entered.numpy()[:whole].reshape(-1, 8)
    assert (groups == groups[:, :1]).all()
    tail = entered.numpy()[whole:]  # the tail group's real rays
    assert (tail == tail[:1]).all()
    assert (improved <= entered).all() and entered.sum() > 0
    # any hit within 0.999 of each ray's closest t: a hit exactly where K1 says
    tm = np.where(r1.numpy() >= 0, t1.numpy() * 0.999, t_max).astype(np.float32)
    h2 = TK.tri_any_hit_tables(*_t(o, d, tm, *_tabs(k1)), **k1_kw)
    h4 = TG.tri_any_hit_groups(*_t(o, d, tm, *_tabs(k4)), **k4_kw)
    assert torch.equal(h2, h4)


def test_group_work_covers_the_per_ray_work():
    """Group-granular tiles (the G = 8 work) are at least the per-ray ones
    on the same tables, and equal them with groups of one ray's copies."""
    o, d, t_max, p0, p1, p2 = _scene(5, 96, 900, spread=4.0)
    tab = TG.group_tables(p0, p1, p2, np.arange(900, dtype=np.int32), view_origin=np.zeros(3),
                          clusters_per_slab=8)
    args = _t(o, d, t_max, *_tabs(tab))
    kw = dict(block_t=128, clusters_per_slab=tab.clusters_per_slab)
    _, _, e1, _ = TK.tri_closest_hit_plain(*args, **kw, use_supers=True, stats=True)
    _, _, e8, _ = TG.tri_closest_hit_groups_plain(*args, **kw, stats=True)
    assert (e8 >= e1).all() and e8.sum() > e1.sum()
    rep = [torch.repeat_interleave(x, 8, dim=0) for x in args[:3]]
    _, _, e1r, _ = TK.tri_closest_hit_plain(*rep, *args[3:], **kw, use_supers=True, stats=True)
    _, _, e8r, _ = TG.tri_closest_hit_groups_plain(*rep, *args[3:], **kw, stats=True)
    assert torch.equal(e1r, e8r)


def test_guard_refuses_tables_without_supers():
    """The walk always has the super level (the TPU kernel's missing guard):
    clusters_per_slab % 8 != 0 and tables without one super box per 8
    clusters raise."""
    o, d, t_max, p0, p1, p2 = _scene(3, 16, 900, spread=4.0)
    prim = np.arange(900, dtype=np.int32)
    no_sup = TK.build_tri_tables(p0, p1, p2, prim, block_t=32, clusters_per_slab=16,
                                 use_supers=False)
    assert no_sup.super_aabbs.shape[0] == 1 and no_sup.cluster_aabbs.shape[0] > 8
    args = _t(o, d, t_max, *_tabs(no_sup))
    for fn in (TG.tri_closest_hit_groups, TG.tri_any_hit_groups):
        with pytest.raises(ValueError, match="super"):
            fn(*args, block_t=32, clusters_per_slab=16)
    tiny = TK.build_tri_tables(p0[:300], p1[:300], p2[:300], prim[:300], block_t=64)
    assert tiny.clusters_per_slab % 8 != 0  # 5 clusters, exact count
    args = _t(o, d, t_max, *_tabs(tiny))
    with pytest.raises(ValueError, match="clusters_per_slab"):
        TG.tri_closest_hit_groups(*args, block_t=64, clusters_per_slab=tiny.clusters_per_slab)


@pytest.mark.parametrize("kind", ["mesh10k", "soup"])
def test_group_tables_equal_jax(kind):
    """K4's tables (block_t 128, clusters_per_slab 128, supers) are equal to
    the JAX package's on mesh10k and on a random soup."""
    if kind == "mesh10k":
        from pathlib import Path

        from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file

        repo = Path(__file__).resolve().parents[1]
        scene = compile_scene_file(repo / "scenes" / "mesh10k.pbrt")
        tris = scene.tris
        p0, p1, p2, prim = tris.p0, tris.p1, tris.p2, tris.prim
        view = np.asarray(scene.camera.camera_to_world)[:3, 3]
    else:
        _, _, _, p0, p1, p2 = _scene(9, 1, 4000, spread=8.0)
        prim, view = np.arange(4000, dtype=np.int32), np.array([0.0, 0.0, -12.0])
    tab = TG.group_tables(p0, p1, p2, prim, view_origin=view)
    jtab = JK.build_tri_tables(p0, p1, p2, prim, block_t=128, view_origin=view,
                               clusters_per_slab=128, use_supers=True)
    for f in ("p0", "p1", "p2", "prim", "valid", "tris16", "cluster_aabbs", "super_aabbs",
              "slab_aabbs"):
        np.testing.assert_array_equal(getattr(tab, f), getattr(jtab, f), err_msg=f)
    assert (tab.block_t, tab.clusters_per_slab, tab.use_supers) == (
        jtab.block_t, jtab.clusters_per_slab, jtab.use_supers)
    assert tab.super_aabbs.shape[0] == tab.cluster_aabbs.shape[0] // 8
