"""The port's closest-hit (K1) and any-hit (K2) traversal, plain PyTorch
versions, against the JAX package's Pallas kernels in interpret mode
(curry_pbrt_tpu/ops/pallas/intersect_kernel.py), on the same numpy inputs.

Both packages must build identical tables. Then:
  - hit masks and any-hit results are equal;
  - table rows are equal wherever the closest t is unique;
  - t agrees within rtol 1e-6 (the JAX package's own kernel-vs-brute
    tolerance) plus atol 1e-6: XLA's CPU lowering contracts a*b+c into FMAs
    while the port rounds every op separately, and for a hit a few
    thousandths of a unit from the origin t_scaled = Σ e_i·z_i cancels terms
    of size ~1, so its relative error is unbounded while its absolute error
    stays near one ULP of the O(8)-unit coordinates (2^-21 ≈ 4.8e-7).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from curry_pbrt_tpu.ops.pallas import intersect_kernel as JK
from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX
from curry_pbrt_tpu_torch.ops.kernels import intersect_kernel as TK

RTOL, ATOL = 1e-6, 1e-6


def _scene(seed, n_rays, n_tris, spread):
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
    p1 = p0 + rng.normal(0, 0.7, (n_tris, 3)).astype(np.float32)
    p2 = p0 + rng.normal(0, 0.7, (n_tris, 3)).astype(np.float32)
    o = rng.uniform(-4, 4, (n_rays, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full((n_rays,), 100.0, np.float32)
    t_max[::7] = 0.0  # dead lanes: never enter a box, never hit
    return o, d, t_max, p0, p1, p2


def _tables(p0, p1, p2, block_t, cps, use_supers):
    prim = np.arange(p0.shape[0], dtype=np.int32)
    kw = dict(block_t=block_t, view_origin=np.zeros(3), clusters_per_slab=cps,
              use_supers=use_supers)
    ja = JK.build_tri_tables(p0, p1, p2, prim, **kw)
    ta = TK.build_tri_tables(p0, p1, p2, prim, **kw)
    for f in ("p0", "p1", "p2", "prim", "valid", "tris16", "cluster_aabbs",
              "super_aabbs", "slab_aabbs"):
        np.testing.assert_array_equal(getattr(ja, f), getattr(ta, f), err_msg=f)
    assert (ja.block_t, ja.clusters_per_slab, ja.use_supers) == (
        ta.block_t, ta.clusters_per_slab, ta.use_supers)
    return ta


def _run_both(o, d, t_max, tab):
    arrs = (o, d, t_max, tab.tris16, tab.cluster_aabbs, tab.super_aabbs, tab.slab_aabbs)
    kw = dict(block_t=tab.block_t, clusters_per_slab=tab.clusters_per_slab,
              use_supers=tab.use_supers)
    jt, ji = JK.tri_closest_hit_tables(*map(jnp.asarray, arrs), interpret=True, **kw)
    jh = JK.tri_any_hit_tables(*map(jnp.asarray, arrs), interpret=True, **kw)
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]
    tt, ti = TK.tri_closest_hit_tables(*targs, **kw)
    th = TK.tri_any_hit_tables(*targs, **kw)
    return (np.asarray(jt), np.asarray(ji), np.asarray(jh)), (tt.numpy(), ti.numpy(), th.numpy())


def _assert_same(jax_out, port_out, tab, o, d, t_max):
    jt, ji, jh = jax_out
    tt, ti, th = port_out
    np.testing.assert_array_equal(ji >= 0, ti >= 0)
    np.testing.assert_array_equal(jh, th)
    hit = ti >= 0
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=RTOL, atol=ATOL)
    assert np.all(tt[~hit] == FLOAT_MAX) and np.all(jt[~hit] == FLOAT_MAX)
    # rows agree wherever the closest hit is unique: recompute every
    # triangle's t for the hit rays and skip rays whose runner-up ties
    tr = torch.from_numpy(tab.tris16)
    for i in np.nonzero(hit)[0]:
        t_all = TK._tile_test(tr, torch.from_numpy(o[i:i + 1]), *TK.ray_shear(
            torch.from_numpy(d[i:i + 1])), torch.from_numpy(t_max[i:i + 1]))[0].numpy()
        if np.sum(t_all == t_all.min()) == 1:
            assert ti[i] == ji[i], (i, ti[i], ji[i])
    # dead lanes never hit
    assert not np.any(ti[t_max == 0] >= 0) and not np.any(th[t_max == 0])


@pytest.mark.parametrize(
    "seed,n_tris,block_t,cps,use_supers",
    [
        (0, 37, 8, 256, None),
        (1, 37, 64, 256, None),
        (4, 300, 8, 256, None),
        (2, 300, 64, 256, None),
        (5, 900, 8, 16, True),  # supers + 8 slabs
    ],
    ids=["37tri-bt8", "37tri-bt64", "300tri-bt8", "300tri-bt64", "900tri-supers-slabs"],
)
def test_plain_kernels_match_jax(seed, n_tris, block_t, cps, use_supers):
    o, d, t_max, p0, p1, p2 = _scene(seed, 192, n_tris, spread=2.0 if n_tris < 900 else 4.0)
    tab = _tables(p0, p1, p2, block_t, cps, use_supers)
    if n_tris == 900:
        assert tab.use_supers and tab.n_slabs > 1
    jax_out, port_out = _run_both(o, d, t_max, tab)
    assert (port_out[1] >= 0).sum() > 5  # the case really hits something
    _assert_same(jax_out, port_out, tab, o, d, t_max)


def test_first_hit_exactly_at_t_max():
    """With t_max set to each ray's closest hit t, the hit is still
    reported at exactly t_max (the first-hit exception to strict
    improvement) — unless the watertight range test, which compares
    t_scaled against t_max·det in other roundings, rejects it; both
    packages must agree ray for ray."""
    o, d, t_max, p0, p1, p2 = _scene(3, 96, 37, spread=2.0)
    tab = _tables(p0, p1, p2, 8, 256, None)
    _, (t_free, i_free, _) = _run_both(o, d, np.full_like(t_max, 100.0), tab)
    hit = i_free >= 0
    assert hit.sum() > 5
    t_exact = np.where(hit, t_free, 100.0).astype(np.float32)
    jax_out, port_out = _run_both(o, d, t_exact, tab)
    kept = port_out[1] >= 0
    assert not np.any(kept & ~hit)
    assert kept.sum() >= hit.sum() - 2  # the exception really fires
    np.testing.assert_array_equal(port_out[0][kept], t_exact[kept])
    np.testing.assert_array_equal(port_out[1][kept], i_free[kept])
    _assert_same(jax_out, port_out, tab, o, d, t_exact)


def test_nan_padding_cluster_is_never_entered():
    """A NaN box (an empty cluster) must not be entered even by a ray whose
    origin sits inside every slab: torch.minimum/maximum propagate NaN."""
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.6, 0.8, 0.0]])
    box = torch.full((8,), float("nan"))
    inv_d = 1.0 / torch.where(d == 0, 1e-30, d)
    assert not TK._box_enter(box, o, inv_d, torch.full((4,), 100.0)).any()
    good = torch.tensor([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0, 0.0, 0.0])
    assert TK._box_enter(good, o, inv_d, torch.full((4,), 100.0)).all()
    # dead lanes (t_best == 0) never enter, even a box around their origin
    assert not TK._box_enter(good, o, inv_d, torch.zeros(4)).any()


def test_wrapper_rejects_bad_tables():
    o, d, t_max, p0, p1, p2 = _scene(0, 8, 37, 2.0)
    tab = _tables(p0, p1, p2, 8, 256, None)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (o, d, t_max, tab.tris16, tab.cluster_aabbs, tab.super_aabbs, tab.slab_aabbs)]
    with pytest.raises(ValueError):
        TK.tri_closest_hit_tables(*args, block_t=64, clusters_per_slab=tab.clusters_per_slab,
                                  use_supers=False)
    args[2] = args[2].double()
    with pytest.raises(TypeError):
        TK.tri_any_hit_tables(*args, block_t=8, clusters_per_slab=tab.clusters_per_slab,
                              use_supers=False)


def test_stats_do_not_change_results_and_bound_the_tpu_counts():
    """stats=True (the bound's instrumentation) returns the same (t, row)
    plus per-ray (entered, improved) counts with the JAX test's invariants
    (tests/test_pallas_intersect.py:409-440). The JAX kernel counts per ray
    block (one sub-group here), the port per ray, so each ray's counts are
    at most its block's: a ray enters only tiles its block entered."""
    o, d, t_max, p0, p1, p2 = _scene(51, 300, 900, spread=4.0)
    tab = _tables(p0, p1, p2, 64, 256, True)
    arrs = (o, d, t_max, tab.tris16, tab.cluster_aabbs, tab.super_aabbs, tab.slab_aabbs)
    kw = dict(block_t=tab.block_t, clusters_per_slab=tab.clusters_per_slab,
              use_supers=tab.use_supers)
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]
    t0, i0 = TK.tri_closest_hit_tables(*targs, **kw)
    t1, i1, entered, improved = TK.tri_closest_hit_tables(*targs, **kw, stats=True)
    assert torch.equal(t0, t1) and torch.equal(i0, i1)
    entered, improved = entered.numpy(), improved.numpy()
    assert entered.sum() > 0 and improved.sum() > 0
    assert entered.max() <= tab.cluster_aabbs.shape[0]
    assert (improved <= entered).all()
    np.testing.assert_array_equal(improved > 0, i1.numpy() >= 0)
    assert entered[t_max == 0].sum() == 0  # dead lanes enter nothing
    _, _, j_entered, j_improved = JK.tri_closest_hit_tables(
        *map(jnp.asarray, arrs), interpret=True, block_r=512, stats=True, **kw)
    assert (entered <= np.asarray(j_entered)).all()
    assert (improved <= np.asarray(j_improved)).all()
    # the any-hit plain version counts the tiles it entered up to its first hit
    hit, any_entered = TK.tri_any_hit_plain(*targs, **kw, stats=True)
    assert torch.equal(hit, TK.tri_any_hit_tables(*targs, **kw))
    assert (any_entered.numpy() <= entered).all()
