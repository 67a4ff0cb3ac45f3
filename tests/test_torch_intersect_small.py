"""The small-table walk (csrc/intersect_small.cu: K1, its stats variant K1b,
and K2 over the small-scene plan's tables of at most 8 rows a cluster),
without a card: its launch plan, what its wrappers refuse, and a
plain-PyTorch rehearsal of its schedule held against the plain versions and
against the JAX package's kernels.

The rehearsal runs each CTA as the card does, with the kernel's own
constants (read from the source): a run of THREADS x scan consecutive rays;
the dead rays (t_max <= 0, NaN) written (FLOAT_MAX, -1, 0, 0) / False at
once; the live rays stable-partitioned by bin (the dominant axis of |d|),
so in (bin, ray index) order; the ordered rays walked 32 at a time, as one
warp's iteration takes them: with the dominant axis fixed where the 32
share it (the triangle test's permutation by constant indices, fmax in its
error bounds, as tri_test<KZ, true>), else with each ray's own axis (as
tri_test<-1, true>), each box tested in box_near's form (fmin / fmax and
one NaN flag) as the walk reaches it; the results scattered back to each
ray's own index. It must give the
plain version's (t, row, entered, improved) and any-hit bit for bit: that is
the claim the kernel's design rests on, and what chip_smoke.py and
tests/test_torch_intersect_small_card.py hold the kernel to on the card.

Against the JAX package's Pallas kernels (interpret mode, as
tests/test_pallas_intersect.py runs them on the CPU): hit masks and any-hit
equal, rows equal wherever the closest t is unique, t within rtol 1e-6 plus
an atol of about one ULP of the scene's coordinates —
tests/test_torch_intersect_kernel.py's tolerance and its argument (XLA's
CPU lowering contracts a*b+c into FMAs, the port rounds every operation, and
t_scaled = sum e_i z_i cancels terms of the coordinates' size): 1e-6 there,
for coordinates of O(8) (one ULP 2^-21 ~ 4.8e-7), scaled here by the largest
coordinate over 8 (the Cornell box's O(556) units: 7e-5). No t_max-tie batch:
whether a hit at exactly t_max passes the range test t_scaled <= t_max * det
turns on the rounding of that product, which XLA contracts.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curry_pbrt_tpu.ops.pallas import intersect_kernel as JK
from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX
from curry_pbrt_tpu_torch.ops import intersect as isect
from curry_pbrt_tpu_torch.ops.kernels import build
from curry_pbrt_tpu_torch.ops.kernels import intersect_kernel as TK
from curry_pbrt_tpu_torch.ops.kernels.aggregate import SMALL_SCENE_TRIS, plan_tri_kernel
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file
from curry_pbrt_tpu_torch.tools import probe_small_walk as PS

FMAX = float(FLOAT_MAX)
RTOL, ATOL = 1e-6, 1e-6
SCENES = Path(__file__).resolve().parents[1] / "scenes"
BOX_C, SPREAD = (278.0, 274.0, 280.0), 280.0  # chip_smoke.py's rays about the Cornell box


def _constants():
    src = (build.CSRC / "intersect_small.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+)", src)}


CU = _constants()


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the tier-1 run puts several xdist workers on
    the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# inputs


def _cornell():
    scene = compile_scene_file(SCENES / "cornell_tex.pbrt")
    return plan_tri_kernel(scene.tris, np.asarray(scene.camera.camera_to_world)[:3, 3])


def _soup(n_clusters, seed, nan_cluster=False):
    """block_t-8 tables of n_clusters clusters (the last one partly
    padding); with nan_cluster, an empty cluster (invalid rows, a NaN box)
    inserted in the middle of the walk's order."""
    rng = np.random.default_rng(seed)
    n_tris = n_clusters * 8 - 3
    p0 = rng.uniform(-8, 8, (n_tris, 3)).astype(np.float32)
    p1 = p0 + rng.normal(0, 1.2, (n_tris, 3)).astype(np.float32)
    p2 = p0 + rng.normal(0, 1.2, (n_tris, 3)).astype(np.float32)
    tab = TK.build_tri_tables(p0, p1, p2, np.arange(n_tris, dtype=np.int32), block_t=8,
                              view_origin=np.zeros(3), use_supers=False)
    if not nan_cluster:
        return tab
    c = tab.cluster_aabbs.shape[0] // 2
    pad = np.zeros((8, 16), np.float32)
    pad[:, 9] = -1.0
    box = np.concatenate([tab.cluster_aabbs[:c], np.full((1, 8), np.nan, np.float32),
                          tab.cluster_aabbs[c:]])
    return dataclasses.replace(
        tab, tris16=np.concatenate([tab.tris16[:c * 8], pad, tab.tris16[c * 8:]]),
        cluster_aabbs=box, clusters_per_slab=box.shape[0],
        slab_aabbs=TK.union_boxes(box[None]), super_aabbs=TK.union_boxes(box[None]))


def _rays(n, seed, center, spread, dead_every=7):
    rng = np.random.default_rng(seed)
    o = (np.asarray(center, np.float32) + rng.uniform(-spread, spread, (n, 3))).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(rng.uniform(size=n) < 0.5, FMAX, spread).astype(np.float32)
    if dead_every:
        t_max[::dead_every] = 0.0
    return o, d, t_max


def _args(tab, o, d, t_max):
    arrs = (o, d, t_max, tab.tris16, tab.cluster_aabbs, tab.super_aabbs, tab.slab_aabbs)
    kw = dict(block_t=tab.block_t, clusters_per_slab=tab.clusters_per_slab,
              use_supers=tab.use_supers)
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs], kw


def _case(name):
    """(tables, (o, d, t_max), min_ctas) of one named case."""
    if name.startswith("soup"):
        nc = int(name.split("-")[1])
        tab = _soup(nc, 10 + nc, nan_cluster=name.endswith("nan"))
        return tab, _rays(1501, 20 + nc, (0, 0, 0), 9.0), CU["MIN_CTAS"]
    tab = _cornell()
    if name == "cornell":
        return tab, _rays(1200, 1, BOX_C, SPREAD), CU["MIN_CTAS"]
    if name == "cornell-ragged-scan4":  # scan 4: 1024-ray CTAs, the last one ragged
        return tab, _rays(4 * 1024 + 37, 2, BOX_C, SPREAD), 1
    if name == "cornell-one-ray":
        return tab, _rays(1, 3, BOX_C, SPREAD, dead_every=0), CU["MIN_CTAS"]
    o, d, t_max = _rays(1000, 4, BOX_C, SPREAD)
    if name == "cornell-tmax-tie":
        (args, kw) = _args(tab, o, d, t_max)
        t_p, _ = TK.tri_closest_hit_plain(*args, **kw)
        return tab, (o, d, np.where(t_p.numpy() < 1e30, t_p.numpy(), t_max)), CU["MIN_CTAS"]
    if name == "cornell-90pct-dead":
        rng = np.random.default_rng(5)
        dead = np.where(rng.uniform(size=1000) < 0.5, 0.0, -1.0)
        return tab, (o, d, np.where(rng.uniform(size=1000) < 0.1, t_max, dead).astype(
            np.float32)), 1
    if name == "cornell-all-dead":
        return tab, (o, d, np.zeros_like(t_max)), CU["MIN_CTAS"]
    assert name == "cornell-all-live"
    return tab, (o, d, np.full_like(t_max, FMAX)), CU["MIN_CTAS"]


CASES = ["cornell", "cornell-ragged-scan4", "cornell-one-ray", "cornell-tmax-tie",
         "cornell-90pct-dead", "cornell-all-dead", "cornell-all-live", "soup-64",
         "soup-40-nan", "soup-3"]


# ---------------------------------------------------------------------------
# the rehearsal


def _axis_bin(d):
    """Each ray's bin: make_ray's dominant axis (the first maximum of |d|),
    as axis_bin computes it."""
    a = d.abs()
    return torch.where((a[:, 0] >= a[:, 1]) & (a[:, 0] >= a[:, 2]), 0,
                       torch.where(a[:, 1] >= a[:, 2], 1, 2))


def _tri_test_kz(rows, o, kz, sx, sy, sz, t_best):
    """tri_test<KZ, true> of rays (N,) against rows (B, 16) → (N, B) t,
    FLOAT_MAX where there is no hit, fmax in the error bounds: kz an int
    (the rays share the dominant axis; the permutation by constant indices)
    or an (N,) tensor (each ray's own axis, tri_test<-1, true>)."""
    q = [rows[None, :, 3 * v:3 * v + 3] - o[:, None, :] for v in range(3)]
    if isinstance(kz, int):
        comp = lambda p, k: p[..., k]  # noqa: E731
    else:
        comp = lambda p, k: p.gather(-1, k[:, None, None].expand(*p.shape[:2], 1))[..., 0]  # noqa: E731
    kx, ky = (kz + 1) % 3, (kz + 2) % 3
    sx, sy, sz, tb = (x[:, None] for x in (sx, sy, sz, t_best))
    x = [comp(p, kx) + sx * comp(p, kz) for p in q]
    y = [comp(p, ky) + sy * comp(p, kz) for p in q]
    e0 = x[1] * y[2] - y[1] * x[2]
    e1 = x[2] * y[0] - y[2] * x[0]
    e2 = x[0] * y[1] - y[0] * x[1]
    same_side = ~(((e0 < 0) | (e1 < 0) | (e2 < 0)) & ((e0 > 0) | (e1 > 0) | (e2 > 0)))
    det = e0 + e1 + e2
    z0, z1, z2 = (comp(p, kz) * sz for p in q)
    t_scaled = e0 * z0 + e1 * z1 + e2 * z2
    in_range = torch.where(det < 0, (t_scaled < 0) & (t_scaled >= tb * det),
                           (t_scaled > 0) & (t_scaled <= tb * det))
    inv_det = 1.0 / torch.where(det == 0, 1.0, det)
    t = t_scaled * inv_det
    fmax3 = lambda a, b, c: torch.fmax(a.abs(), torch.fmax(b.abs(), c.abs()))  # noqa: E731
    max_zt, max_xt, max_yt = fmax3(z0, z1, z2), fmax3(*x), fmax3(*y)
    delta_z = isect._G3 * max_zt
    delta_x = isect._G5 * (max_xt + max_zt)
    delta_y = isect._G5 * (max_yt + max_zt)
    delta_e = 2.0 * (isect._G2 * max_xt * max_yt + delta_y * max_xt + delta_x * max_yt)
    max_e = fmax3(e0, e1, e2)
    delta_t = 3.0 * (isect._G3 * max_e * max_zt + delta_e * max_zt + delta_z * max_e) * \
        torch.abs(inv_det)
    ok = same_side & (det != 0) & in_range & (t > delta_t) & (rows[None, :, 9] > 0)
    return torch.where(ok, t, FMAX)


def _box_near(box, o, inv_d):
    """Each ray's entry distance into one box, NaN where it never enters
    (box_near): fmin / fmax, one NaN flag over the six slab distances."""
    t0, t1 = (box[0:3] - o) * inv_d, (box[3:6] - o) * inv_d
    nan = torch.isnan(t0).any(1) | torch.isnan(t1).any(1)
    near, far = torch.fmin(t0, t1), torch.fmax(t0, t1) * float(TK.T_SCALE)
    tn = torch.fmax(near[:, 0], torch.fmax(near[:, 1], near[:, 2]))
    tf = torch.fmin(far[:, 0], torch.fmin(far[:, 1], far[:, 2]))
    return torch.where(~nan & (tn <= tf) & (tf > 0), tn, float("nan"))


def _walk(prims, caabb, block, o, d, t_max, shared_axis, any_hit):
    """One warp's iteration of live rays, with their shared dominant axis
    fixed (shared_axis) or each ray's own: the closest-hit walk → (t, row,
    entered, improved), or the any-hit walk → hit."""
    inv_d = 1.0 / torch.where(d == 0, 1e-30, d)
    kz_ray, sx, sy, sz = isect.ray_shear(d)
    kz = int(kz_ray[0]) if shared_axis else kz_ray
    t_best = t_max.clone()
    idx = torch.full(t_max.shape, -1, dtype=torch.int32)
    entered, improved = torch.zeros_like(idx, dtype=torch.int32), torch.zeros_like(idx)
    hit = torch.zeros(t_max.shape, dtype=torch.bool)
    for c in range(caabb.shape[0]):
        bound = t_max if any_hit else t_best
        ids = torch.nonzero((_box_near(caabb[c], o, inv_d) < bound) & ~hit).squeeze(1)
        if ids.numel() == 0:
            continue
        tb = bound[ids]
        t = _tri_test_kz(prims[c * block:(c + 1) * block], o[ids],
                         kz if shared_axis else kz[ids], sx[ids], sy[ids], sz[ids], tb)
        if any_hit:
            hit[ids] = (t < FMAX).any(1)
            continue
        t_min, row = torch.min(t, dim=1)  # first index of the minimum
        cur = idx[ids]
        better = (t_min < tb) | ((t_min == tb) & (cur < 0) & (t_min < FMAX))
        t_best[ids] = torch.where(better, t_min, tb)
        idx[ids] = torch.where(better, (c * block + row).to(torch.int32), cur)
        entered[ids] += 1
        improved[ids] += better.to(torch.int32)
    if any_hit:
        return (hit,)
    return torch.where(idx >= 0, t_best, FMAX), idx, entered, improved


def rehearse(tab, o, d, t_max, any_hit, min_ctas):
    """The card's schedule (module docstring) → (t, row, entered, improved)
    or (hit,), every output written exactly once."""
    o, d, t_max = (torch.from_numpy(np.ascontiguousarray(a)) for a in (o, d, t_max))
    prims, caabb = torch.from_numpy(tab.tris16), torch.from_numpy(tab.cluster_aabbs)
    n, threads = o.shape[0], CU["THREADS"]
    scan = min(CU["MAX_SCAN"], max(1, n // (threads * min_ctas)))
    if any_hit:
        outs = [torch.ones(n, dtype=torch.bool)]
        dead = (False,)
    else:
        outs = [torch.full((n,), float("nan")), torch.full((n,), -7, dtype=torch.int32),
                torch.full((n,), -7, dtype=torch.int32), torch.full((n,), -7, dtype=torch.int32)]
        dead = (FMAX, -1, 0, 0)
    written = torch.zeros(n, dtype=torch.int32)
    for base in range(0, n, threads * scan):
        ray = torch.arange(base, min(base + threads * scan, n))
        live = t_max[ray] > 0
        for out, v in zip(outs, dead):  # dead rays: no ray set-up
            out[ray[~live]] = v
        written[ray[~live]] += 1
        b = _axis_bin(d[ray])
        lv = torch.nonzero(live).squeeze(1)
        order = ray[lv[torch.sort(b[lv], stable=True).indices]]  # (bin, ray index) order
        assert torch.equal(torch.sort(order).values, ray[lv]) and int(b.max()) < CU["BINS"]
        for w in range(0, order.numel(), 32):  # one warp's iteration: 32 consecutive slots
            grp = order[w:w + 32]
            kz = isect.ray_shear(d[grp])[0]
            assert torch.equal(kz, _axis_bin(d[grp]))  # the bin is make_ray's kz
            res = _walk(prims, caabb, tab.block_t, o[grp], d[grp], t_max[grp],
                        bool((kz == kz[0]).all()), any_hit)
            for out, r in zip(outs, res):
                out[grp] = r
            written[grp] += 1
    assert (written == 1).all()
    return tuple(outs)


@pytest.mark.parametrize("case", CASES)
def test_rehearsal_is_the_plain_versions(case):
    tab, rays, min_ctas = _case(case)
    args, kw = _args(tab, *rays)
    t_p, r_p, e_p, i_p = TK.tri_closest_hit_plain(*args, **kw, stats=True)
    h_p = TK.tri_any_hit_plain(*args, **kw)
    t_s, r_s, e_s, i_s = rehearse(tab, *rays, any_hit=False, min_ctas=min_ctas)
    (h_s,) = rehearse(tab, *rays, any_hit=True, min_ctas=min_ctas)
    assert torch.equal(t_s.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(r_s, r_p) and torch.equal(e_s, e_p) and torch.equal(i_s, i_p)
    assert torch.equal(h_s, h_p)
    live = int((args[2] > 0).sum())
    if case == "cornell-all-dead":
        assert live == 0 and not (r_p >= 0).any()
    elif case != "cornell-one-ray":
        assert int((r_p >= 0).sum()) > min(20, live // 10)  # the case really hits
    if case == "cornell-tmax-tie":  # the first-hit-at-t_max rule decides these rays
        at = (r_p >= 0) & (t_p == args[2])
        assert int(at.sum()) > 100
    if case == "soup-40-nan":
        assert int(np.isnan(tab.cluster_aabbs[:, 0]).sum()) == 1


def _ulp_scale(tab, o):
    """The largest coordinate of the valid rows and the origins, over 8."""
    rows = tab.tris16[tab.tris16[:, 9] > 0, :9]
    return max(float(np.abs(rows).max()), float(np.abs(o).max())) / 8.0


@pytest.mark.parametrize("case", ["cornell", "cornell-90pct-dead", "soup-64", "soup-40-nan"])
def test_rehearsal_matches_jax(case):
    tab, (o, d, t_max), min_ctas = _case(case)
    n = min(o.shape[0], 256)
    o, d, t_max = o[:n], d[:n], t_max[:n]
    arrs = (o, d, t_max, tab.tris16, tab.cluster_aabbs, tab.super_aabbs, tab.slab_aabbs)
    kw = dict(block_t=tab.block_t, clusters_per_slab=tab.clusters_per_slab,
              use_supers=tab.use_supers)
    jt, ji = (np.asarray(x) for x in JK.tri_closest_hit_tables(*map(jnp.asarray, arrs),
                                                                interpret=True, **kw))
    jh = np.asarray(JK.tri_any_hit_tables(*map(jnp.asarray, arrs), interpret=True, **kw))
    tt, ti, _, _ = (x.numpy() for x in rehearse(tab, o, d, t_max, False, min_ctas))
    th = rehearse(tab, o, d, t_max, True, min_ctas)[0].numpy()
    np.testing.assert_array_equal(ji >= 0, ti >= 0)
    np.testing.assert_array_equal(jh, th)
    hit = ti >= 0
    assert hit.sum() > 5
    atol = ATOL * _ulp_scale(tab, o)
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=RTOL, atol=atol)
    assert np.all(tt[~hit] == FMAX) and np.all(jt[~hit] == FMAX)
    tr = torch.from_numpy(tab.tris16)
    for i in np.nonzero(hit)[0]:  # rows agree wherever the closest t is unique
        t_all = TK._tile_test(tr, torch.from_numpy(o[i:i + 1]), *isect.ray_shear(
            torch.from_numpy(d[i:i + 1])), torch.from_numpy(t_max[i:i + 1]))[0].numpy()
        if np.sum(t_all == t_all.min()) == 1:
            assert ti[i] == ji[i], (i, ti[i], ji[i])


# ---------------------------------------------------------------------------
# the plan and the wrappers


def test_launch_plan_sends_small_tables_to_the_small_walk():
    """block_t <= 8: the small-table walk for triangles; beyond, and for
    sphere tables at every size (the small walk has no sphere test): the
    warp walk. Every table the small-scene plan builds fits the walk's
    shared memory."""
    assert TK.launch_plan(8) == TK.launch_plan(1) == "small"
    assert TK.launch_plan(8, spheres=True) == TK.launch_plan(1, spheres=True) == "warp"
    assert TK.launch_plan(9) == TK.launch_plan(64) == TK.launch_plan(64, spheres=True) == "warp"
    assert TK.SMALL_MAX_BLOCK_T == CU["MAX_BLOCK"]
    assert TK.SMALL_TABLE_MAX_BYTES == CU["MAX_TABLE_BYTES"]
    assert (TK.SMALL_ROW_BYTES, TK.SMALL_BOX_BYTES) == (4 * CU["ROW"], 32)
    # the order list (THREADS x MAX_SCAN ints) and the counts fit beside the
    # largest table in the 48 KB a block has without opting in
    counts = CU["BINS"] * CU["MAX_SCAN"] * (CU["THREADS"] // 32) + 1
    assert CU["MAX_TABLE_BYTES"] + 4 * (CU["THREADS"] * CU["MAX_SCAN"] + counts) <= 48 * 1024
    largest = TK.small_table_bytes(SMALL_SCENE_TRIS // 8, 8)
    assert largest == 64 * (8 * 48 + 32) <= TK.SMALL_TABLE_MAX_BYTES
    tab = _cornell()
    assert (tab.block_t, tab.n_slabs, tab.use_supers) == (8, 1, False)
    assert TK.DeviceTables(tab, "cpu").plan == "small"
    assert TK.small_table_bytes(tab.cluster_aabbs.shape[0], 8) < 2048


def test_small_wrappers_refuse_what_the_walk_cannot_stage():
    """tri_*_hit_small refuse, on every device, tables with several slabs,
    supers, more than 8 rows a cluster, or more than SMALL_TABLE_MAX_BYTES
    of staged rows and boxes (98 clusters of 8 fit, 99 do not); on the CPU
    the planned wrappers run the plain versions whatever the table."""
    o, d, t_max = _rays(64, 6, (0, 0, 0), 9.0)
    fits = _soup(98, 1)
    big = _soup(99, 2)
    rng = np.random.default_rng(3)
    p = [rng.uniform(-8, 8, (300, 3)).astype(np.float32) for _ in range(3)]
    slabs = TK.build_tri_tables(*p, np.arange(300, dtype=np.int32), block_t=8,
                                clusters_per_slab=16)
    supers = TK.build_tri_tables(*p, np.arange(300, dtype=np.int32), block_t=8,
                                 use_supers=True)
    wide = TK.build_tri_tables(*p, np.arange(300, dtype=np.int32), block_t=16)
    assert slabs.n_slabs > 1 and supers.use_supers and fits.cluster_aabbs.shape[0] == 98
    before = dict(TK.LAUNCHES)
    for fn, plain in ((TK.tri_closest_hit_small, TK.tri_closest_hit_plain),
                      (TK.tri_any_hit_small, TK.tri_any_hit_plain)):
        args, kw = _args(fits, o, d, t_max)
        got, want = fn(*args, **kw), plain(*args, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want)) if isinstance(got, tuple) \
            else torch.equal(got, want)
        for tab, match in ((big, "bytes"), (slabs, "one slab"), (supers, "one slab"),
                           (wide, "one slab")):
            args, kw = _args(tab, o, d, t_max)
            with pytest.raises(ValueError, match=match):
                fn(*args, **kw)
        args, kw = _args(big, o, d, t_max)
        planned = TK.tri_closest_hit_tables if fn is TK.tri_closest_hit_small \
            else TK.tri_any_hit_tables
        planned(*args, **kw)  # the CPU takes the plain version
    assert TK.LAUNCHES == before  # plain-version calls are not launches


def test_small_walk_entry_points_are_declared():
    assert {"curry_tri_closest_hit_small", "curry_tri_any_hit_small"} <= set(build.ENTRY_POINTS)
    assert build.ENTRY_POINTS["curry_tri_closest_hit_small"] == \
        build.ENTRY_POINTS["curry_tri_closest_hit_warp"]
    assert build.ENTRY_POINTS["curry_tri_any_hit_small"] == \
        build.ENTRY_POINTS["curry_tri_any_hit_warp"]
    assert {"tri_closest_small", "tri_closest_stats_small", "tri_any_small"} <= set(TK.LAUNCHES)


@pytest.mark.parametrize("variant", sorted(PS.VARIANTS))
def test_probe_variants_build_from_the_shipped_source(variant):
    """tools/probe_small_walk.py's variants (the walk with its elements
    taken out) apply every substitution to the shipped source exactly as
    often as they should; the probe refuses to run off the card."""
    src = PS.variant_source(variant)
    assert src != PS.SOURCE.read_text()
    for _, new, _ in PS.VARIANTS[variant]:
        assert new in src
    with pytest.raises(ValueError, match="device must be cuda"):
        PS.analyze(SCENES / "cornell_tex.pbrt", device="cpu")
