"""The port's sphere cluster traversal (K3), plain PyTorch versions, against
the JAX package's Pallas sphere kernels in interpret mode
(curry_pbrt_tpu/ops/pallas/sphere_kernel.py), on the same numpy inputs.

Both packages must build identical tables (array_equal). Then, ray by ray:
  - hit masks and any-hit results are equal;
  - t agrees within rtol 1e-5 plus atol 1e-6 (about one ULP of the O(10)
    coordinates, for hits close to the origin): both compute the kernel's
    stable quadratic operation for operation, but XLA's CPU lowering
    contracts a*b+c into FMAs and torch's vectorised CPU sqrt is not
    correctly rounded (about 0.6% of values one ULP off), and the
    quadratic's cancellation near tangency amplifies a last-bit difference;
  - the sphere reached through row_sphere is equal wherever the closest t
    is unique (the kernel's tie winner follows table order).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from curry_pbrt_tpu.ops.pallas import sphere_kernel as JS
from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX
from curry_pbrt_tpu_torch.ops.kernels import sphere_kernel as TS

RTOL, ATOL = 1e-5, 1e-6
FIELDS = ("sph16", "row_sphere", "cluster_aabbs", "super_aabbs", "slab_aabbs")


def _spheres(seed, n, spread=12.0, rigid_only=False):
    """Random rotated (and, unless rigid_only, anisotropically scaled)
    spheres → (w2o, o2w, radius, prim) numpy arrays."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    radii = rng.uniform(0.1, 0.6, n).astype(np.float32)
    o2w = np.zeros((n, 4, 4), np.float32)
    w2o = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if not rigid_only:
            q = q @ np.diag(rng.uniform(0.7, 1.4, 3))
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = q.astype(np.float32)
        m[:3, 3] = centers[i]
        o2w[i] = m
        w2o[i] = np.linalg.inv(m).astype(np.float32)
    return w2o, o2w, radii, np.arange(n, dtype=np.int32)


def _translated_spheres(seed, n):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    radii = rng.uniform(0.1, 0.5, n).astype(np.float32)
    o2w = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    o2w[:, :3, 3] = centers
    w2o = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    w2o[:, :3, 3] = -centers
    return w2o, o2w, radii, np.arange(n, dtype=np.int32)


def _rays(seed, n, spread=14.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full((n,), 1e30, np.float32)
    t_max[::16] = 0.0  # dead lanes
    return o, d, t_max


def _on_surface(seed, n, n_small=69):
    """A unit sphere at the origin among n_small small spheres, and rays
    starting exactly on its surface, at (±1, 0, 0), (0, ±1, 0) and
    (0, 0, ±1), in random directions: each hits it at t = ±0 (-0.0 where it
    leaves the sphere: c = +0 over q < 0). No dead lanes: the JAX kernel
    tests an entered tile for every ray of its group, and a dead ray
    (t_max 0) on a surface passes the sphere test at t = 0 = t_max, so it
    reports a hit there that the port's per-ray box gate never enters; the
    integrators discard a dead ray's result."""
    rng = np.random.default_rng(seed)
    o2w = np.tile(np.eye(4, dtype=np.float32), (n_small + 1, 1, 1))
    o2w[1:, :3, 3] = rng.uniform(-3, 3, (n_small, 3))
    w2o = np.linalg.inv(o2w).astype(np.float32)
    radius = np.concatenate([[1.0], rng.uniform(0.1, 0.3, n_small)]).astype(np.float32)
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    o = axes[rng.integers(0, 6, n)]
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full((n,), 1e30, np.float32)
    return (w2o, o2w, radius, np.arange(n_small + 1, dtype=np.int32)), (o, d, t_max)


def _tables(arrays, **kw):
    jt = JS.build_sphere_tables(*arrays, view_origin=np.zeros(3), **kw)
    tt = TS.build_sphere_tables(*arrays, view_origin=np.zeros(3), **kw)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(jt, f), getattr(tt, f), err_msg=f)
    assert (jt.block_s, jt.clusters_per_slab, jt.use_supers) == (
        tt.block_s, tt.clusters_per_slab, tt.use_supers)
    return tt


def _run_both(tab, o, d, t_max):
    arrs = (o, d, t_max, tab.sph16, tab.cluster_aabbs, tab.super_aabbs, tab.slab_aabbs)
    kw = dict(block_s=tab.block_s, clusters_per_slab=tab.clusters_per_slab,
              use_supers=tab.use_supers)
    jx = [jnp.asarray(a) for a in arrs]
    jt, jr = JS.sphere_closest_hit_tables(*jx, interpret=True, block_r=512, **kw)
    jh = JS.sphere_any_hit_tables(*jx, interpret=True, block_r=512, **kw)
    tx = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]
    tt, tr = TS.sphere_closest_hit_tables(*tx, **kw)
    th = TS.sphere_any_hit_tables(*tx, **kw)
    return (np.asarray(jt), np.asarray(jr), np.asarray(jh)), (tt.numpy(), tr.numpy(), th.numpy())


def _assert_same(tab, o, d, t_max, jax_out, port_out):
    jt, jr, jh = jax_out
    tt, tr, th = port_out
    np.testing.assert_array_equal(jr >= 0, tr >= 0)
    np.testing.assert_array_equal(jh, th)
    hit = tr >= 0
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=RTOL, atol=ATOL)
    assert np.all(tt[~hit] == FLOAT_MAX) and np.all(jt[~hit] == FLOAT_MAX)
    assert not np.any(hit[t_max == 0]) and not np.any(th[t_max == 0])  # dead lanes
    # the sphere each ray reached, wherever its closest t is unique
    rows = torch.from_numpy(tab.sph16)
    for i in np.nonzero(hit)[0]:
        t_all = TS._sphere_tile_test(rows, torch.from_numpy(o[i:i + 1]), torch.from_numpy(d[i:i + 1]),
                                     torch.from_numpy(t_max[i:i + 1]))[0].numpy()
        if np.sum(t_all == t_all.min()) == 1:
            assert tab.row_sphere[tr[i]] == tab.row_sphere[jr[i]], i


@pytest.mark.parametrize(
    "case",
    ["translation-700", "affine-300", "supers-slabs-1500", "on-surface"],
)
def test_plain_sphere_kernels_match_jax(case):
    """On the on-surface case (rays starting on a sphere, 512 of them) t
    must also agree in its sign bit: both give -0.0 for the rays that leave
    the sphere."""
    o, d, t_max = _rays(5, 768)
    if case == "translation-700":
        tab = _tables(_translated_spheres(0, 700))
    elif case == "affine-300":
        tab = _tables(_spheres(3, 300))
    elif case == "on-surface":
        arrays, (o, d, t_max) = _on_surface(17, 512)
        tab = _tables(arrays)
    else:  # supers, several slabs and a NaN padding cluster
        tab = _tables(_spheres(7, 1500), clusters_per_slab=16, use_supers=True)
        assert tab.use_supers and tab.slab_aabbs.shape[0] > 1
        assert np.isnan(tab.cluster_aabbs[:, 0]).any()
    jax_out, port_out = _run_both(tab, o, d, t_max)
    assert (port_out[1] >= 0).sum() > 50  # the case really hits something
    _assert_same(tab, o, d, t_max, jax_out, port_out)
    if case == "on-surface":
        (jt, jr, _), (tt, tr, _) = jax_out, port_out
        assert (tr >= 0).all() and (tt == 0.0).all()  # every ray hits at ±0
        np.testing.assert_array_equal(np.signbit(tt), np.signbit(jt))
        np.testing.assert_array_equal(tab.row_sphere[tr], tab.row_sphere[jr])
        assert np.signbit(tt).sum() > 100  # -0.0 hits, not only +0.0


def test_first_hit_exactly_at_t_max():
    """With t_max set to each ray's closest t, the hit is still reported at
    exactly t_max (the first-hit exception to strict improvement). Each
    package gets its own closest t as t_max, since the two differ in the
    last bits; both must keep every hit, at the same sphere."""
    tab = _tables(_spheres(11, 400))
    o, d, t_max = _rays(9, 512)
    (jt_free, jr_free, _), (tt_free, tr_free, _) = _run_both(tab, o, d, t_max)
    hit = tr_free >= 0
    assert hit.sum() > 50
    np.testing.assert_array_equal(jr_free >= 0, hit)
    jax_exact = np.where(hit, jt_free, t_max).astype(np.float32)
    port_exact = np.where(hit, tt_free, t_max).astype(np.float32)
    (jt, jr, _), _ = _run_both(tab, o, d, jax_exact)
    _, (tt, tr, _) = _run_both(tab, o, d, port_exact)
    np.testing.assert_array_equal(tr >= 0, hit)
    np.testing.assert_array_equal(jr >= 0, hit)
    np.testing.assert_array_equal(tt[hit], port_exact[hit])
    np.testing.assert_array_equal(jt[hit], jax_exact[hit])
    np.testing.assert_array_equal(tab.row_sphere[tr[hit]], tab.row_sphere[tr_free[hit]])
    np.testing.assert_array_equal(tab.row_sphere[tr[hit]], tab.row_sphere[jr[hit]])


def test_stats_count_entered_tiles():
    """The plain versions' entered-tile counts (the bound's input for K3)
    are at most the cluster count per ray, and improved ≤ entered."""
    tab = _tables(_spheres(13, 900), clusters_per_slab=16, use_supers=True)
    o, d, t_max = (torch.from_numpy(a) for a in _rays(3, 256))
    args = (o, d, t_max) + tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        tab.sph16, tab.cluster_aabbs, tab.super_aabbs, tab.slab_aabbs))
    kw = dict(block_s=tab.block_s, clusters_per_slab=tab.clusters_per_slab,
              use_supers=tab.use_supers)
    t, row, entered, improved = TS.sphere_closest_hit_plain(*args, **kw, stats=True)
    t0, row0 = TS.sphere_closest_hit_tables(*args, **kw)
    assert torch.equal(t, t0) and torch.equal(row, row0)
    assert (entered <= tab.cluster_aabbs.shape[0]).all() and (improved <= entered).all()
    assert torch.equal(improved > 0, row >= 0) and int(entered[t_max == 0].sum()) == 0
    hit, any_entered = TS.sphere_any_hit_plain(*args, **kw, stats=True)
    assert torch.equal(hit, row >= 0)
    assert (any_entered <= entered).all()  # any-hit stops at its first hit
