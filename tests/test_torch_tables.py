"""The port's cluster tables and kernel-backed aggregate
(curry_pbrt_tpu_torch/ops/kernels/intersect_kernel.py, aggregate.py) against
the table and aggregate tests of tests/test_pallas_intersect.py.

Orders and tables are integer data and must equal the JAX package's
(array_equal). The aggregate, over the plain versions of K1 / K2 on the
CPU, is held against the port's brute intersector with the JAX test's
tolerances (t rtol 1e-6, points rtol 1e-4 / atol 1e-5, prims and any-hit
equal); the 600k-triangle subsample against a chunked brute t with its
rtol 5e-6.

Mirrored elsewhere: the brute, padding, multi-slab, stats and group tests
(tests/test_torch_intersect_brute.py, test_torch_intersect_kernel.py,
test_torch_intersect_group.py). Not mirrored:
test_subgroup_predication_matches_brute, because its 128-lane sub-groups
are a TPU vector layout with no counterpart in the port (each CUDA thread
or warp walks its own ray).
"""

import sys
from pathlib import Path

import numpy as np
import torch

from curry_pbrt_tpu.ops.pallas import intersect_kernel as JK
from curry_pbrt_tpu_torch.ops import intersect as isect
from curry_pbrt_tpu_torch.ops.kernels import intersect_kernel as K
from curry_pbrt_tpu_torch.ops.kernels.aggregate import make_kernel_intersectors

REPO = Path(__file__).resolve().parents[1]


def _random_scene(seed, n_rays=64, n_tris=37, spread=2.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
    p0 = base
    p1 = base + rng.normal(0, 0.7, (n_tris, 3)).astype(np.float32)
    p2 = base + rng.normal(0, 0.7, (n_tris, 3)).astype(np.float32)
    o = rng.uniform(-4, 4, (n_rays, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full((n_rays,), 100.0, np.float32)
    return o, d, t_max, p0, p1, p2


def test_morton_order_is_permutation():
    _o, _d, _t, p0, p1, p2 = _random_scene(11, n_tris=500, spread=5.0)
    order = K.morton_order(p0, p1, p2)
    assert sorted(order.tolist()) == list(range(500))
    np.testing.assert_array_equal(order, JK.morton_order(p0, p1, p2))


def test_kdmedian_order_properties():
    """A deterministic permutation whose block_t runs are kd cells, equal
    to the JAX package's, and tighter (total cluster surface area) than
    Morton runs on a structured mesh."""
    for n in (500, 512, 65):  # non-multiple, exact, barely-splittable
        _o, _d, _t, p0, p1, p2 = _random_scene(11, n_tris=n, spread=5.0)
        order = K.kdmedian_order(p0, p1, p2, 64)
        assert sorted(order.tolist()) == list(range(n))
        np.testing.assert_array_equal(order, K.kdmedian_order(p0, p1, p2, 64))
        np.testing.assert_array_equal(order, JK.kdmedian_order(p0, p1, p2, 64))

    gx, gy = np.meshgrid(np.arange(40, dtype=np.float32), np.arange(40, dtype=np.float32))
    base = np.stack([gx.ravel(), gy.ravel(), (gx * 0.1 + gy * 0.07).ravel()], -1)
    p0 = base.astype(np.float32)
    p1 = (base + [0.8, 0.1, 0.0]).astype(np.float32)
    p2 = (base + [0.1, 0.8, 0.05]).astype(np.float32)
    valid = np.ones((base.shape[0],), bool)

    def total_sa(order):
        boxes = K.block_aabbs(p0[order], p1[order], p2[order], valid[order], 64)
        ext = np.maximum(boxes[:, 3:6] - boxes[:, 0:3], 0)
        return float(np.nansum(2 * (ext[:, 0] * ext[:, 1] + ext[:, 0] * ext[:, 2]
                                    + ext[:, 1] * ext[:, 2])))

    assert total_sa(K.kdmedian_order(p0, p1, p2, 64)) <= total_sa(K.morton_order(p0, p1, p2))


def test_build_tri_tables_is_permutation_with_padding():
    _o, _d, _t, p0, p1, p2 = _random_scene(23, n_tris=777, spread=3.0)
    kw = dict(block_t=64, view_origin=np.array([1.0, 2.0, 3.0]), use_supers=True)
    tables = K.build_tri_tables(p0, p1, p2, np.arange(777, dtype=np.int32), **kw)
    real = tables.prim[tables.prim >= 0]
    assert sorted(real.tolist()) == list(range(777))
    # vertex rows follow their prim ids through the permutation
    np.testing.assert_array_equal(tables.p0[tables.valid], p0[real])
    # AABB levels contain their children
    assert tables.use_supers
    grouped = tables.cluster_aabbs.reshape(tables.super_aabbs.shape[0], K.SUPER_G, 8)
    ok_rows = ~np.isnan(grouped[..., 0])
    for s in range(tables.super_aabbs.shape[0]):
        for c in range(K.SUPER_G):
            if ok_rows[s, c]:
                assert (grouped[s, c, 0:3] >= tables.super_aabbs[s, 0:3] - 1e-6).all()
                assert (grouped[s, c, 3:6] <= tables.super_aabbs[s, 3:6] + 1e-6).all()
    jt = JK.build_tri_tables(p0, p1, p2, np.arange(777, dtype=np.int32), **kw)
    for f in ("prim", "tris16", "cluster_aabbs", "super_aabbs", "slab_aabbs"):
        np.testing.assert_array_equal(getattr(tables, f), np.asarray(getattr(jt, f)), err_msg=f)


def test_aggregate_matches_brute_on_mesh():
    """The kernel aggregate (tables, clusters, attributes) against brute on
    a multi-cluster mesh with a sphere."""
    o, d, t_max, p0, p1, p2 = _random_scene(13, n_rays=128, n_tris=260, spread=4.0)
    tris = isect.TriangleArrays(p0, p1, p2, np.arange(260, dtype=np.int32))
    eye = np.eye(4, dtype=np.float32)[None]
    sph = isect.SphereArrays(eye, eye, np.asarray([1.2], np.float32), np.asarray([260], np.int32))
    inter, pred, tprim = make_kernel_intersectors(tris, sph, "cpu")
    o, d, t_max = (torch.from_numpy(a) for a in (o, d, t_max))
    tris_t = isect.TriangleArrays(*(torch.from_numpy(a) for a in tris))
    sph_t = isect.SphereArrays(*(torch.from_numpy(a) for a in sph))
    got = inter(o, d, t_max)
    ref = isect.intersect_brute(o, d, t_max, tris_t, sph_t)
    np.testing.assert_array_equal(got.prim.numpy(), ref.prim.numpy())
    hit = ref.prim.numpy() >= 0
    assert hit.sum() > 20
    np.testing.assert_allclose(got.t.numpy()[hit], ref.t.numpy()[hit], rtol=1e-6)
    np.testing.assert_allclose(got.p.numpy()[hit], ref.p.numpy()[hit], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(pred(o, d, t_max).numpy(),
                                  isect.intersect_predicate_brute(o, d, t_max, tris_t, sph_t).numpy())
    t2, prim2 = tprim(o, d, t_max)
    np.testing.assert_array_equal(prim2.numpy(), ref.prim.numpy())
    np.testing.assert_allclose(t2.numpy()[hit], ref.t.numpy()[hit], rtol=1e-6)


def test_600k_tri_scene_matches_brute_subsample():
    """Scene-size ceiling: a synthetic 620k-triangle torus in streamed
    slabs (built from arrays, not through the scene compiler), 64 probe
    rays, against a brute t computed in triangle chunks."""
    sys.path.insert(0, str(REPO / "tools"))
    from make_mesh_scene import bumpy_torus

    idx, verts = bumpy_torus(nu=775, nv=400)
    tri = verts[idx.reshape(-1, 3)].astype(np.float32)
    p0, p1, p2 = (np.ascontiguousarray(tri[:, k]) for k in range(3))
    n_tris = tri.shape[0]
    assert n_tris >= 600_000

    rng = np.random.default_rng(31)
    theta = rng.uniform(0, 2 * np.pi, 64)
    o = np.stack([3.0 * np.cos(theta), rng.uniform(-1, 2, 64), 3.0 * np.sin(theta)],
                 -1).astype(np.float32)
    d = tri[rng.integers(0, n_tris, 64), 0] - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_max = np.full((64,), 100.0, np.float32)

    tables = K.build_tri_tables(p0, p1, p2, np.arange(n_tris, dtype=np.int32), block_t=64,
                                view_origin=np.array([0.0, 0.0, -4.0]))
    assert tables.n_slabs > 2  # actually exercises streaming
    o_t, d_t, tm_t = (torch.from_numpy(a) for a in (o, d, t_max))
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        tables.tris16, tables.cluster_aabbs, tables.super_aabbs, tables.slab_aabbs)]
    t, widx = K.tri_closest_hit_tables(o_t, d_t, tm_t, *args, block_t=tables.block_t,
                                       clusters_per_slab=tables.clusters_per_slab,
                                       use_supers=tables.use_supers)
    t, widx = t.numpy(), widx.numpy()

    ref_t = np.full((64,), np.inf, np.float32)
    ref_any = np.zeros((64,), bool)
    step = 65536
    for lo in range(0, n_tris, step):
        hi = min(lo + step, n_tris)
        sub = isect.TriangleArrays(*(torch.from_numpy(a[lo:hi]) for a in (p0, p1, p2)),
                                   torch.arange(hi - lo, dtype=torch.int32))
        tt, _b, ok = isect.triangle_intersect_t(o_t, d_t, tm_t, sub, with_bary=False)
        ref_t = np.minimum(ref_t, tt.min(dim=-1).values.numpy())
        ref_any |= ok.any(dim=-1).numpy()

    assert np.array_equal(widx >= 0, ref_any)
    np.testing.assert_allclose(t[ref_any], ref_t[ref_any], rtol=5e-6, atol=0)
