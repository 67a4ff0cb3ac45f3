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

The CUDA kernel's schedule (csrc/intersect_group.cu: the group's strict box
votes, the per-ray non-strict gate with its slack, the lanes' row split and reduction for
the gated rays) is rehearsed in plain PyTorch and held to the plain
versions bit for bit, with no tolerance: t's bits, rows and any-hit; so are
the plain versions under the gate (gate=True), whose tile counts lie
between each ray's own strict entries and the group rule's.
"""

from pathlib import Path

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


# ---------------------------------------------------------------------------
# the CUDA kernel's schedule (csrc/intersect_group.cu), rehearsed in PyTorch

WARP = 32
CHUNK_ROWS = 128  # rows the warp holds in registers at once (4 a lane)


def _rehearse(o, d, t_max, tab, any_hit=False, gate="slack"):
    """K4's kernel schedule over all groups at once: the group votes on each
    slab, super and cluster box with the strict test (box_near < bound); in
    a visited cluster the gated rays (gate "slack": box_near <= bound *
    GATE_SLACK, the kernel's; "exact": box_near <= bound; "strict":
    box_near < bound; or a bound of +inf) test the rows; lane l holds rows
    base + l + 32 j of each 128-row chunk and keeps its least t, lowest row
    on a tie; the lanes reduce to the least t, then the lowest row holding
    it; lane q keeps its ray's minimum over the chunks (strict <) and
    applies K1's acceptance rule (any hit: a hit ends the ray; a hit ray's
    bound is 0). Returns (t, row) or the any-hit mask."""
    n = o.shape[0]
    o, d, t_max = TG._padded(o, d, t_max)
    caabb, saabb, slab = (torch.from_numpy(np.ascontiguousarray(a)) for a in (
        tab.cluster_aabbs, tab.super_aabbs, tab.slab_aabbs))
    rows_all = torch.from_numpy(tab.tris16)
    block, cps = tab.block_t, tab.clusters_per_slab
    inv_d = 1.0 / torch.where(d == 0, float(np.float32(1e-30)), d)
    kz, sx, sy, sz = TK.ray_shear(d)
    t_best = t_max.clone()
    idx = torch.full(t_max.shape, -1, dtype=torch.int32)
    hit = torch.zeros(t_max.shape, dtype=torch.bool)
    bound = (lambda: torch.where(hit, 0.0, t_max)) if any_hit else (lambda: t_best)
    fmax = float(TK.FLOAT_MAX)

    def vote(box):
        b = bound()
        enter = (TK._box_near(box, o, inv_d) < b) & (b > 0)
        return enter.view(-1, 8).any(dim=1).repeat_interleave(8)

    def visit(c, visiting):
        b = bound()
        tn = TK._box_near(caabb[c], o, inv_d)
        passes = {"slack": lambda: tn <= b * TG.GATE_SLACK, "exact": lambda: tn <= b,
                  "strict": lambda: tn < b}[gate]()
        ids = torch.nonzero(visiting & (passes | torch.isinf(b)) & (b > 0)).squeeze(1)
        if ids.numel() == 0:
            return
        frozen = b[ids]
        tile_t = torch.full((ids.numel(),), fmax)
        tile_row = torch.zeros((ids.numel(),), dtype=torch.int64)
        for base in range(0, block, CHUNK_ROWS):
            i = base + torch.arange(CHUNK_ROWS)  # row i on lane i % 32, slot (i - base) // 32
            rows = rows_all[c * block + i.clamp(max=block - 1)]
            t = TK._tile_test(rows, o[ids], kz[ids], sx[ids], sy[ids], sz[ids], frozen)
            t = torch.where(i < block, t, fmax)
            lane_t = t.view(-1, CHUNK_ROWS // WARP, WARP)  # (rays, slot j, lane)
            lane_min, j = torch.min(lane_t, dim=1)  # per lane: the lowest slot wins a tie
            lane_row = base + torch.arange(WARP) + WARP * j
            t_min = lane_min.min(dim=1).values
            row = torch.where(lane_min == t_min[:, None], lane_row, 1 << 30).min(dim=1).values
            better_chunk = t_min < tile_t
            tile_t = torch.where(better_chunk, t_min, tile_t)
            tile_row = torch.where(better_chunk, row, tile_row)
        if any_hit:
            hit[ids] |= tile_t < fmax
            return
        cur = idx[ids]
        better = (tile_t < frozen) | ((tile_t == frozen) & (cur < 0) & (tile_t < fmax))
        t_best[ids] = torch.where(better, tile_t, frozen)
        idx[ids] = torch.where(better, (c * block + tile_row).to(torch.int32), cur)

    n_sup = cps // 8
    for j in range(slab.shape[0]):
        in_slab = vote(slab[j]) if slab.shape[0] > 1 else \
            (bound() > 0).view(-1, 8).any(dim=1).repeat_interleave(8)
        for s in range(n_sup):
            in_sup = in_slab & vote(saabb[j * n_sup + s])
            for c_off in range(8):
                c = j * cps + s * 8 + c_off
                visit(c, in_sup & vote(caabb[c]))
    if any_hit:
        return hit[:n]
    return torch.where(idx >= 0, t_best, fmax)[:n], idx[:n]


def _rays(n, seed, live):
    """n rays about the soup; live: "7th-dead" (every 7th lane dead), a share
    of live lanes, "one-a-group" (lane 3 of each group of 8), or "inf"
    (every 7th lane dead, the others' t_max +inf: the group rule then
    accepts an all-miss tile, at FLT_MAX)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full((n,), 100.0, np.float32)
    if live in ("7th-dead", "inf"):
        t_max[::7] = 0.0
        if live == "inf":
            t_max[t_max > 0] = np.inf
    elif live == "one-a-group":
        t_max[np.arange(n) % 8 != 3] = 0.0
    else:
        t_max[rng.uniform(size=n) >= live] = 0.0
    return o, d, t_max


def _soup_tables(block_t, cps, n_tris=900, seed=17):
    """The JAX test's soup (900 triangles) in K4's tables: at (128, 8) one
    slab, at (32, 16) two slabs whose last 3 clusters are NaN padding."""
    _, _, _, p0, p1, p2 = _scene(seed, 1, n_tris, spread=6.0)
    return TG.group_tables(p0, p1, p2, np.arange(n_tris, dtype=np.int32), view_origin=np.zeros(3),
                           block_t=block_t, clusters_per_slab=cps)


def _hold_rehearsal(tab, o, d, t_max):
    """The rehearsed schedule against the plain versions (the group rule),
    bit for bit: t's bits, rows, any-hit; and the plain versions under the
    gate equal to both."""
    kw = dict(block_t=tab.block_t, clusters_per_slab=tab.clusters_per_slab)
    args = _t(o, d, t_max, *_tabs(tab))
    t_p, r_p = TG.tri_closest_hit_groups_plain(*args, **kw)
    t_g, r_g = TG.tri_closest_hit_groups_plain(*args, **kw, gate=True)
    h_p = TG.tri_any_hit_groups_plain(*args, **kw)
    h_g = TG.tri_any_hit_groups_plain(*args, **kw, gate=True)
    t_r, r_r = _rehearse(*args[:3], tab)
    h_r = _rehearse(*args[:3], tab, any_hit=True)
    for t, r in ((t_r, r_r), (t_g, r_g)):
        assert torch.equal(t.view(torch.int32), t_p.view(torch.int32))
        assert torch.equal(r, r_p)
    assert torch.equal(h_r, h_p) and torch.equal(h_g, h_p)
    assert not (r_r[~(args[2] > 0)] >= 0).any() and not h_r[~(args[2] > 0)].any()
    return int((r_p >= 0).sum())


@pytest.mark.parametrize("block_t,cps", [(128, 8), (32, 16)], ids=["one-slab", "multi-slab-nan"])
@pytest.mark.parametrize("n,live", [(256, "7th-dead"), (1, 1.0), (7, 1.0), (9, "7th-dead"),
                                    (64, 0.0), (128, 1.0), (128, "one-a-group"), (64, "inf")],
                         ids=["256", "n1", "n7", "n9", "all-dead", "all-live", "one-live-a-group",
                              "t_max-inf"])
def test_kernel_schedule_is_the_plain_version(block_t, cps, n, live):
    """The schedule of csrc/intersect_group.cu — group votes, the per-ray
    non-strict gate, the lanes' row split and reduction for the gated rays
    only — gives the plain versions' t, rows and any-hit bit for bit."""
    tab = _soup_tables(block_t, cps)
    assert (tab.n_slabs > 1) == (cps == 16)
    assert (cps == 16) == bool(np.isnan(tab.cluster_aabbs[:, 0]).any())
    rays = _rays(n, 40 + n, live)
    n_live = int((rays[2] > 0).sum())
    hits = _hold_rehearsal(tab, *rays)
    assert hits == 0 if n_live == 0 else (n_live < 16 or hits > n_live // 8)


def test_kernel_schedule_on_ragged_4097_rays_and_two_chunks():
    """4097 rays (a tail group of one ray) on a multi-slab soup, and 256-row
    clusters, which the kernel takes as two 128-row chunks."""
    _hold_rehearsal(_soup_tables(32, 16, n_tris=1900, seed=21), *_rays(4097, 3, "7th-dead"))
    _hold_rehearsal(_soup_tables(256, 8, n_tris=1500, seed=5), *_rays(300, 4, "7th-dead"))


def test_kernel_schedule_at_t_max_ties():
    """t_max set to each ray's own closest t (the first-hit-at-t_max rule
    decides every hit ray), and the face-tie batch of the probe tool."""
    from curry_pbrt_tpu_torch.tools.probe_group_kernel import face_tie_batch

    tab = _soup_tables(128, 8)
    o, d, t_max = _rays(256, 7, "7th-dead")
    kw = dict(block_t=128, clusters_per_slab=8)
    t_p, _ = TG.tri_closest_hit_groups_plain(*_t(o, d, t_max, *_tabs(tab)), **kw)
    t_tie = np.where(t_p.numpy() < 1e30, t_p.numpy(), t_max).astype(np.float32)
    assert _hold_rehearsal(tab, o, d, t_tie) > 50
    ftab, rays, tie = face_tie_batch(n_soup=1500, n_rays=512)
    assert _hold_rehearsal(ftab, *rays) > 100


def test_strict_gate_loses_the_first_hit_at_t_max():
    """On the face-tie batch each tie ray's only acceptable hit is at exactly
    t_max in a cluster whose box_near is t_max: the group rule (its group
    visits) accepts it, the non-strict gate keeps it, a strict gate — and
    K1's per-ray walk on the same tables — lose it."""
    from curry_pbrt_tpu_torch.tools.probe_group_kernel import face_tie_batch

    tab, (o, d, t_max), tie = face_tie_batch(n_soup=1500, n_rays=512)
    args = _t(o, d, t_max, *_tabs(tab))
    kw = dict(block_t=tab.block_t, clusters_per_slab=tab.clusters_per_slab)
    t_p, r_p = TG.tri_closest_hit_groups_plain(*args, **kw)
    h_p = TG.tri_any_hit_groups_plain(*args, **kw)
    assert (t_p[tie] == 4.0).all() and (r_p[tie] >= 0).all() and h_p[tie].all()
    assert (tab.prim[r_p[tie].numpy()] == 0).all()  # the z = 4 triangle
    t_s, r_s = _rehearse(*args[:3], tab, gate="strict")
    h_s = _rehearse(*args[:3], tab, any_hit=True, gate="strict")
    t_1, r_1 = TK.tri_closest_hit_plain(*args, **kw, use_supers=True)
    for r in (r_s, r_1):
        assert (r[tie] < 0).all()
        others = np.setdiff1d(np.arange(len(t_max)), tie)
        assert torch.equal(r[others], r_p[others])
    assert not h_s[tie].any() and torch.equal(t_s[tie], torch.full((len(tie),), float(TK.FLOAT_MAX)))


def _face_crossings(axis, seed):
    """Axis-aligned walls (rectangles' triangles on the plane axis = 4) and
    rays from the other side along +z: per hit, (t - tn) / tn, where t is the
    watertight test's and tn the ray's box_near into the triangle's own
    box, the tightest box that holds it (a cluster's box only enters
    sooner)."""
    rng = np.random.default_rng(seed)
    n_q, n = 300, 4096
    x0, y0 = rng.uniform(-6, 6, n_q), rng.uniform(-6, 6, n_q)
    w, h = rng.uniform(0.3, 3, n_q), rng.uniform(0.3, 3, n_q)
    corners = (np.stack([x0, y0], 1), np.stack([x0 + w, y0], 1), np.stack([x0 + w, y0 + h], 1))
    p = [torch.from_numpy(np.insert(q, axis, 4.0, axis=1).astype(np.float32)) for q in corners]
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    d[:, 2] = 1.0
    if axis != 2:  # the wall across x, hit by rays still dominant in z
        o[:, axis] = rng.uniform(-3, 0, n)
        d[:, axis] = np.abs(d[:, axis]) + 0.4
    else:
        o[:, 2] = rng.uniform(-3, 0, n)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    rows = torch.zeros((n_q, 16))
    rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], rows[:, 9] = p[0], p[1], p[2], 1.0
    t = TK._tile_test(rows, o, *TK.ray_shear(d), torch.full((n,), 1e30))
    boxes = torch.cat([torch.minimum(torch.minimum(p[0], p[1]), p[2]),
                       torch.maximum(torch.maximum(p[0], p[1]), p[2]), torch.zeros((n_q, 2))], 1)
    inv_d = 1.0 / d
    tn = torch.stack([TK._box_near(boxes[j], o, inv_d) for j in range(n_q)], 1)
    hit = (t < 1e30) & (tn > 0)
    return ((t[hit].double() - tn[hit].double()) / tn[hit].double()).numpy()


@pytest.mark.parametrize("axis", [2, 0], ids=["wall-across-z", "wall-across-x"])
def test_gate_slack_covers_the_face_crossing(axis):
    """A triangle on a face of its box (an axis-aligned wall) can have its
    computed t below the box's computed box_near: by at most 6 × 2^-24
    relative here, which the kernel's GATE_SLACK (2^-16) covers 40 times
    over."""
    rel = _face_crossings(axis, seed=1)
    assert rel.size > 2000 and rel.min() < 0  # the crossing exists
    assert -rel.min() <= 6 * 2.0 ** -24 and TG.GATE_SLACK == 1 + 2.0 ** -16
    src = (Path(TG.__file__).parents[2] / "csrc" / "intersect_group.cu").read_text()
    assert "GATE_SLACK = 1.0f + 1.0f / 65536.0f" in src


def test_gate_slack_keeps_coplanar_hits():
    """Overlapping coplanar triangles scattered over clusters (the probe's
    coplanar batch): the kernel's schedule equals the plain versions bit for
    bit, while a gate without the slack (box_near <= t_best) loses hits that
    fall below a later cluster's box_near, and so does K1's walk."""
    from curry_pbrt_tpu_torch.tools.probe_group_kernel import coplanar_batch

    tab, rays = coplanar_batch(n_quads=400, n_rays=4096, seed=3)
    assert _hold_rehearsal(tab, *rays) > 2000
    args = _t(*rays, *_tabs(tab))
    kw = dict(block_t=tab.block_t, clusters_per_slab=tab.clusters_per_slab)
    t_p, r_p = TG.tri_closest_hit_groups_plain(*args, **kw)
    t_e, r_e = _rehearse(*args[:3], tab, gate="exact")
    t_1, _ = TK.tri_closest_hit_plain(*args, **kw, use_supers=True)
    for t in (t_e, t_1):
        lost = t != t_p
        assert lost.any() and (t[lost] > t_p[lost]).all()  # a later, farther hit kept


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_gated_work_lies_between_per_ray_and_group_work(kind):
    """The stats under the gate (the tiles the kernel tests) count at least
    each ray's own strict entries (K1's walk on K4's tables) and at most the
    group rule's; strictly fewer than the group rule's on a soup."""
    tab = _soup_tables(32, 16, n_tris=1900, seed=21)
    o, d, t_max = _rays(400, 11, "7th-dead")
    args = _t(o, d, t_max, *_tabs(tab))
    kw = dict(block_t=tab.block_t, clusters_per_slab=tab.clusters_per_slab)
    if kind == "closest":
        *_, e1, _ = TK.tri_closest_hit_plain(*args, **kw, use_supers=True, stats=True)
        *_, e8, _ = TG.tri_closest_hit_groups_plain(*args, **kw, stats=True)
        *_, eg, _ = TG.tri_closest_hit_groups_plain(*args, **kw, stats=True, gate=True)
    else:
        _, e1 = TK.tri_any_hit_plain(*args, **kw, use_supers=True, stats=True)
        _, e8 = TG.tri_any_hit_groups_plain(*args, **kw, stats=True)
        _, eg = TG.tri_any_hit_groups_plain(*args, **kw, stats=True, gate=True)
    assert (e1 <= eg).all() and (eg <= e8).all()
    assert e1.sum() > 0 and eg.sum() < e8.sum()


def test_group_probe_checks_pass_on_the_cpu():
    """tools/probe_group_kernel.py on the CPU (plain versions): every
    bounce's checks hold, the gate's counts lie under the group rule's and
    the tiles at bounce 0 are counted for the bounds."""
    from curry_pbrt_tpu_torch.tools import probe_group_kernel as PK

    s = PK.analyze("mesh10k.pbrt", 1024, 2, "cpu", stats_at=(0,))
    PK.check(s)
    b0, b1 = s["bounces"]
    assert b0["k1_tiles"] > 0 and 0 < b0["gate_tiles"] < b0["group_tiles"]
    assert b1["gate_tiles"] is None and b0["k4_ms"] is None
    assert "K4 vs plain: t bit-equal True" in PK.report(s)


@pytest.mark.parametrize("name", ["group rule", "butterfly", "scalar rows", "run-time axis",
                                  "every chunk", "6 blocks an SM", "pair lanes"])
def test_group_walk_probe_variants_apply(name):
    """Each variant of tools/probe_group_walk.py substitutes into the
    shipped csrc/intersect_group.cu exactly as often as it says."""
    from curry_pbrt_tpu_torch.tools import probe_group_walk as PW

    src = PW.variant_source(name)
    assert src != PW.SOURCE.read_text()
    for _, new, _ in PW.VARIANTS[name]:
        assert new in src
