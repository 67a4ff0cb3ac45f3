"""The port's brute-force aggregate (ops/intersect.py: intersect_brute,
intersect_tprim_brute, intersect_predicate_brute) against the JAX package's,
and the port's traversal plain versions (K1, K2, K4) against the port's
brute: mirrors of tests/test_pallas_intersect.py's "vs brute" tests
(:43, :165, :177, :236, :274). Then render_scene(intersector="brute") on
cornell_tex against its golden.

Tolerances: port vs JAX — prims, hit masks and any-hit equal; t within rtol
1e-5 / atol 1e-4 and p, uv within rtol 1e-5 / atol 1e-3 (coordinates up to
~8 units; XLA's CPU lowering contracts a*b+c into FMAs where the port rounds
each op separately, and the attributes divide by the watertight
determinant). Port vs port — t bit-equal: the traversals and the brute run
the same per-pair arithmetic, and the conservative box test only skips
tests. The render: the slice tolerance of tests/test_torch_render.py.
"""

from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from curry_pbrt_tpu.ops import intersect as JI
from curry_pbrt_tpu_torch.ops import intersect as TI
from curry_pbrt_tpu_torch.ops.kernels import intersect_group as TG
from curry_pbrt_tpu_torch.ops.kernels import intersect_kernel as TK

REPO = Path(__file__).resolve().parents[1]


def _random_scene(seed, n_rays=64, n_tris=37, spread=2.0):
    """tests/test_pallas_intersect.py's _random_scene (numpy)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
    p1 = base + rng.normal(0, 0.7, (n_tris, 3)).astype(np.float32)
    p2 = base + rng.normal(0, 0.7, (n_tris, 3)).astype(np.float32)
    o = rng.uniform(-4, 4, (n_rays, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full((n_rays,), 100.0, np.float32)
    return o, d, t_max, base, p1, p2


def _spheres(seed, n):
    """n rotated, anisotropically scaled spheres: (o2w, w2o, radius, prim)."""
    rng = np.random.default_rng(seed)
    o2w = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        o2w[i, :3, :3] = q @ np.diag(rng.uniform(0.7, 1.4, 3))
        o2w[i, :3, 3] = rng.uniform(-2.5, 2.5, 3)
    w2o = np.linalg.inv(o2w).astype(np.float32)
    return o2w, w2o, rng.uniform(0.3, 0.9, n).astype(np.float32), np.arange(n, dtype=np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("n_sph", [0, 5], ids=["triangles", "triangles+spheres"])
def test_brute_trio_matches_jax(n_sph):
    o, d, t_max, p0, p1, p2 = _random_scene(13, n_rays=160, n_tris=120, spread=2.5)
    t_max[::9] = 0.0  # dead lanes
    prim = np.arange(120, dtype=np.int32)
    prim[7] = -1  # a padding row never hits
    o2w, w2o, radius, sprim = _spheres(3, n_sph)
    sprim = sprim + 120
    jt = JI.TriangleArrays(*map(jnp.asarray, (p0, p1, p2, prim)))
    js = JI.SphereArrays(*map(jnp.asarray, (o2w, w2o, radius, sprim)))
    tt = TI.TriangleArrays(*_t(p0, p1, p2, prim))
    ts = TI.SphereArrays(*_t(o2w, w2o, radius, sprim))
    jr = map(jnp.asarray, (o, d, t_max))
    jo, jd, jtm = jr
    ro, rd, rtm = _t(o, d, t_max)

    jh = JI.intersect_brute(jo, jd, jtm, jt, js)
    th = TI.intersect_brute(ro, rd, rtm, tt, ts)
    np.testing.assert_array_equal(np.asarray(jh.prim), th.prim.numpy())
    hit = th.prim.numpy() >= 0
    assert hit.sum() > 10 and not (th.prim.numpy() == 7).any()
    assert (n_sph == 0) or (th.prim.numpy() >= 120).sum() > 0
    np.testing.assert_allclose(th.t.numpy()[hit], np.asarray(jh.t)[hit], rtol=1e-5, atol=1e-4)
    for f in ("p", "n", "uv"):
        np.testing.assert_allclose(getattr(th, f).numpy()[hit], np.asarray(getattr(jh, f))[hit],
                                   rtol=1e-5, atol=1e-3, err_msg=f)
    assert (th.t.numpy()[~hit] == np.asarray(jh.t)[~hit]).all()

    jt2, jp2 = JI.intersect_tprim_brute(jo, jd, jtm, jt, js)
    tt2, tp2 = TI.intersect_tprim_brute(ro, rd, rtm, tt, ts)
    np.testing.assert_array_equal(np.asarray(jp2), tp2.numpy())
    np.testing.assert_array_equal(tp2.numpy(), th.prim.numpy())
    assert torch.equal(tt2[hit], th.t[hit])

    jpred = JI.intersect_predicate_brute(jo, jd, jtm, jt, js)
    tpred = TI.intersect_predicate_brute(ro, rd, rtm, tt, ts)
    np.testing.assert_array_equal(np.asarray(jpred), tpred.numpy())
    np.testing.assert_array_equal(tpred.numpy(), hit)


def _brute_ref(o, d, t_max, p0, p1, p2, prim):
    tris = TI.TriangleArrays(*_t(p0, p1, p2, prim))
    tt, _, ok = TI.triangle_intersect_t(*_t(o, d, t_max), tris, with_bary=False)
    return tt, tt.min(dim=-1).values, ok.any(dim=-1)


def _tab_args(o, d, t_max, tab):
    return _t(o, d, t_max, tab.tris16, tab.cluster_aabbs, tab.super_aabbs, tab.slab_aabbs)


def _closest_vs_brute(o, d, t_max, p0, p1, p2, tab, closest, kw):
    """A traversal's (t, row) against the brute: hit masks equal, t
    bit-equal, the winning row's prim reproduces the winning t."""
    prim = np.arange(p0.shape[0], dtype=np.int32)
    tt, ref_t, ref_any = _brute_ref(o, d, t_max, p0, p1, p2, prim)
    t, row = closest(*_tab_args(o, d, t_max, tab), **kw)
    assert torch.equal(row >= 0, ref_any)
    assert torch.equal(t[ref_any], ref_t[ref_any])
    won = torch.from_numpy(tab.prim)[row[ref_any].long()]
    assert (won >= 0).all()
    assert torch.equal(tt[ref_any][torch.arange(won.shape[0]), won.long()], ref_t[ref_any])
    return int(ref_any.sum())


@pytest.mark.parametrize("seed,n_tris", [(0, 37), (1, 37), (2, 37), (4, 300)])
def test_closest_hit_matches_brute(seed, n_tris):
    """Mirror of tests/test_pallas_intersect.py:43 for K1 (8- and 64-tri
    clusters) and K4 (8-tri clusters, 16 per slab)."""
    o, d, t_max, p0, p1, p2 = _random_scene(seed, n_tris=n_tris)
    prim = np.arange(n_tris, dtype=np.int32)
    for block_t in (8, 64):
        tab = TK.build_tri_tables(p0, p1, p2, prim, block_t=block_t)
        _closest_vs_brute(o, d, t_max, p0, p1, p2, tab, TK.tri_closest_hit_tables,
                          dict(block_t=block_t, clusters_per_slab=tab.clusters_per_slab,
                               use_supers=tab.use_supers))
    tab = TG.group_tables(p0, p1, p2, prim, block_t=8, clusters_per_slab=16)
    hits = _closest_vs_brute(o, d, t_max, p0, p1, p2, tab, TG.tri_closest_hit_groups,
                             dict(block_t=8, clusters_per_slab=tab.clusters_per_slab))
    assert hits > 0


def test_any_hit_matches_brute():
    """Mirror of tests/test_pallas_intersect.py:165 for K2 and K4."""
    o, d, t_max, p0, p1, p2 = _random_scene(7, n_rays=96, n_tris=21)
    _, _, ref = _brute_ref(o, d, t_max, p0, p1, p2, np.arange(21, dtype=np.int32))
    prim = np.arange(21, dtype=np.int32)
    tab = TK.build_tri_tables(p0, p1, p2, prim, block_t=8)
    got = TK.tri_any_hit_tables(*_tab_args(o, d, t_max, tab), block_t=8,
                                clusters_per_slab=tab.clusters_per_slab, use_supers=False)
    assert torch.equal(got, ref) and ref.sum() > 0
    gtab = TG.group_tables(p0, p1, p2, prim, block_t=8, clusters_per_slab=8)
    got4 = TG.tri_any_hit_groups(*_tab_args(o, d, t_max, gtab), block_t=8,
                                 clusters_per_slab=gtab.clusters_per_slab)
    assert torch.equal(got4, ref)


def test_padding_lanes_are_misses():
    """Mirror of tests/test_pallas_intersect.py:177: padding rows (prim -1)
    never win, in the brute and in K1 / K4 (5 rays: one partial group)."""
    o, d, t_max, p0, p1, p2 = _random_scene(3, n_rays=5, n_tris=3)
    prim = np.array([0, -1, 2], np.int32)
    tris = TI.TriangleArrays(*_t(p0, p1, p2, prim))
    _, best_prim = TI.intersect_tprim_brute(*_t(o, d, t_max), tris,
                                            TI.SphereArrays(*_t(np.zeros((0, 4, 4), np.float32),
                                                                np.zeros((0, 4, 4), np.float32),
                                                                np.zeros(0, np.float32),
                                                                np.zeros(0, np.int32))))
    assert best_prim.shape == (5,) and not (best_prim == 1).any()
    tab = TK.build_tri_tables(p0, p1, p2, prim, block_t=8)
    t, row = TK.tri_closest_hit_tables(*_tab_args(o, d, t_max, tab), block_t=8,
                                       clusters_per_slab=tab.clusters_per_slab, use_supers=False)
    assert t.shape == (5,) and not (tab.prim[row.numpy()[row.numpy() >= 0]] == 1).any()
    gtab = TG.group_tables(p0, p1, p2, prim, block_t=8, clusters_per_slab=8)
    t4, row4 = TG.tri_closest_hit_groups(*_tab_args(o, d, t_max, gtab), block_t=8,
                                         clusters_per_slab=gtab.clusters_per_slab)
    assert torch.equal(t4, t) and not (gtab.prim[row4.numpy()[row4.numpy() >= 0]] == 1).any()


@pytest.mark.parametrize("cps,use_supers", [(16, True), (16, False), (8, False)])
def test_multislab_streaming_matches_brute(cps, use_supers):
    """Mirror of tests/test_pallas_intersect.py:236 (1.9k tris, 2-4 slabs)
    for K1, and for K4 on its own 32-tri, 16-per-slab tables."""
    o, d, t_max, p0, p1, p2 = _random_scene(21, n_rays=256, n_tris=1900, spread=6.0)
    prim = np.arange(1900, dtype=np.int32)
    view = np.array([0.0, 0.0, -10.0])
    tab = TK.build_tri_tables(p0, p1, p2, prim, block_t=64, view_origin=view,
                              clusters_per_slab=cps, use_supers=use_supers)
    assert tab.n_slabs >= 2
    hits = _closest_vs_brute(o, d, t_max, p0, p1, p2, tab, TK.tri_closest_hit_tables,
                             dict(block_t=64, clusters_per_slab=cps, use_supers=tab.use_supers))
    assert hits > 50
    if use_supers:
        gtab = TG.group_tables(p0, p1, p2, prim, view_origin=view, block_t=32,
                               clusters_per_slab=cps)
        assert gtab.n_slabs >= 2
        _closest_vs_brute(o, d, t_max, p0, p1, p2, gtab, TG.tri_closest_hit_groups,
                          dict(block_t=32, clusters_per_slab=cps))


def test_multislab_any_hit_matches_brute():
    """Mirror of tests/test_pallas_intersect.py:274 for K2 and K4."""
    o, d, t_max, p0, p1, p2 = _random_scene(22, n_rays=256, n_tris=1100, spread=6.0)
    prim = np.arange(1100, dtype=np.int32)
    _, _, ref = _brute_ref(o, d, t_max, p0, p1, p2, prim)
    tab = TK.build_tri_tables(p0, p1, p2, prim, block_t=64, clusters_per_slab=8,
                              use_supers=False)
    assert tab.n_slabs >= 2
    got = TK.tri_any_hit_tables(*_tab_args(o, d, t_max, tab), block_t=64,
                                clusters_per_slab=8, use_supers=False)
    assert torch.equal(got, ref) and ref.sum() > 50
    gtab = TG.group_tables(p0, p1, p2, prim, block_t=32, clusters_per_slab=16)
    assert gtab.n_slabs >= 2
    got4 = TG.tri_any_hit_groups(*_tab_args(o, d, t_max, gtab), block_t=32,
                                 clusters_per_slab=16)
    assert torch.equal(got4, ref)


def test_render_brute_matches_golden():
    """render_scene(intersector="brute") on cornell_tex at 32², 4 spp, depth
    3 against tests/goldens/cornell_tex.npy (a JAX CPU render through its
    brute intersector), under the slice tolerance; "bvh" names its item."""
    from curry_pbrt_tpu_torch.render import render_scene
    from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file

    ov = {"resolution": (32, 32), "spp": 4, "max_depth": 3}
    ps = compile_scene_file(REPO / "scenes" / "cornell_tex.pbrt", overrides=ov)
    img = render_scene(ps, device="cpu", show_progress=False, intersector="brute")
    ref = np.load(REPO / "tests" / "goldens" / "cornell_tex.npy")
    assert img.shape == ref.shape and np.isfinite(img).all()
    outside = ~np.isclose(img, ref, rtol=1e-4, atol=1e-4)
    assert outside.mean() <= 0.01, (outside.sum(), np.abs(img - ref).max())
    assert abs(img.sum() - ref.sum()) <= 1e-3 * abs(ref.sum())
    with pytest.raises(NotImplementedError, match="item 13"):
        render_scene(ps, device="cpu", show_progress=False, intersector="bvh")
