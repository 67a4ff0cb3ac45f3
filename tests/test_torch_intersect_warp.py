"""The warp-cooperative walk (csrc/intersect_warp.cu: K1 / K2 over triangles,
K3 over spheres), without a card: its launch plan, what its wrappers refuse,
its bound, and a plain-PyTorch rehearsal of its schedule held against the
plain versions.

The rehearsal walks each ray as one warp of 32 lanes does on the card:
boxes tested 32 at a time against the bound at the batch's start, the
candidates visited in table order and re-tested against the current bound
when it has shrunk since the batch, each entered cluster's rows split over
the lanes (lane l: rows l, l + 32, ...), each lane keeping its lowest row on
a tie, and the lanes' (t, row) reduced as the card reduces them (warp_min:
the least float32 key, its sign cleared for spheres, whose t can be -0.0;
the lowest row holding it; for spheres t from that row's lane). It must
give the plain version's (t, row, entered, improved) and any-hit bit for
bit, t's sign included: that is the claim the kernel's design rests on (the
box test is monotone in the bound), and what chip_smoke.py holds the kernel
to on the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX
from curry_pbrt_tpu_torch.ops.kernels import build
from curry_pbrt_tpu_torch.ops.kernels import intersect_kernel as TK
from curry_pbrt_tpu_torch.ops.kernels import sphere_kernel as TS
from curry_pbrt_tpu_torch.ops.kernels.aggregate import plan_tri_kernel
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file
from curry_pbrt_tpu_torch.tools.roofline import HBM_BYTES_PER_S, bound

FMAX = float(FLOAT_MAX)
WARP = 32  # lanes per ray on the card
SCENES = Path(__file__).resolve().parents[1] / "scenes"


def _scene(seed, n_rays, n_tris, spread):
    """tests/test_torch_intersect_kernel.py's rays and triangles."""
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
    p1 = p0 + rng.normal(0, 0.7, (n_tris, 3)).astype(np.float32)
    p2 = p0 + rng.normal(0, 0.7, (n_tris, 3)).astype(np.float32)
    o = rng.uniform(-4, 4, (n_rays, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full((n_rays,), 100.0, np.float32)
    t_max[::7] = 0.0
    return o, d, t_max, p0, p1, p2


def _tables(p0, p1, p2, block_t, cps, use_supers):
    return TK.build_tri_tables(p0, p1, p2, np.arange(p0.shape[0], dtype=np.int32),
                               block_t=block_t, view_origin=np.zeros(3), clusters_per_slab=cps,
                               use_supers=use_supers)


def _soup(n_tris, seed=0):
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-50, 50, (n_tris, 3)).astype(np.float32)
    p1 = p0 + rng.normal(0, 0.5, (n_tris, 3)).astype(np.float32)
    p2 = p0 + rng.normal(0, 0.5, (n_tris, 3)).astype(np.float32)
    return p0, p1, p2, np.arange(n_tris, dtype=np.int32)


def _sphere_scene(seed, n_rays, n_sph, spread=6.0):
    """n_sph rotated, anisotropically scaled spheres in a box of half-width
    `spread`, and rays from a slightly larger box (t_max 100, every 7th
    dead) → (o, d, t_max, (w2o, o2w, radius, prim))."""
    rng = np.random.default_rng(seed)
    o2w = np.tile(np.eye(4, dtype=np.float32), (n_sph, 1, 1))
    for i in range(n_sph):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        o2w[i, :3, :3] = q @ np.diag(rng.uniform(0.7, 1.4, 3))
        o2w[i, :3, 3] = rng.uniform(-spread, spread, 3)
    w2o = np.linalg.inv(o2w).astype(np.float32)
    radius = rng.uniform(0.1, 0.6, n_sph).astype(np.float32)
    o = rng.uniform(-spread - 1, spread + 1, (n_rays, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full((n_rays,), 100.0, np.float32)
    t_max[::7] = 0.0
    return o, d, t_max, (w2o, o2w, radius, np.arange(n_sph, dtype=np.int32))


def _on_surface(seed, n_rays, n_small=69):
    """A unit sphere at the origin among n_small small spheres, and rays
    that start exactly on its surface, at (±1, 0, 0), (0, ±1, 0) and
    (0, 0, ±1), in random directions: c = |o|² - r² is +0, so a ray that
    leaves the sphere hits it at c / q = +0 / (q < 0) = -0.0, one that
    enters at +0.0 (t_max 100, every 7th dead)."""
    rng = np.random.default_rng(seed)
    o2w = np.tile(np.eye(4, dtype=np.float32), (n_small + 1, 1, 1))
    o2w[1:, :3, 3] = rng.uniform(-3, 3, (n_small, 3))
    w2o = np.linalg.inv(o2w).astype(np.float32)
    radius = np.concatenate([[1.0], rng.uniform(0.1, 0.3, n_small)]).astype(np.float32)
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    o = axes[rng.integers(0, 6, n_rays)]
    d = rng.normal(0, 1, (n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full((n_rays,), 100.0, np.float32)
    t_max[::7] = 0.0
    return o, d, t_max, (w2o, o2w, radius, np.arange(n_small + 1, dtype=np.int32))


def _sphere_tables(arrays, block_s, cps, use_supers):
    return TS.build_sphere_tables(*arrays, block_s=block_s, view_origin=np.zeros(3),
                                  clusters_per_slab=cps, use_supers=use_supers)


def _cornell():
    scene = compile_scene_file(SCENES / "cornell_tex.pbrt")
    return plan_tri_kernel(scene.tris, np.asarray(scene.camera.camera_to_world)[:3, 3])


def _mesh_like(n_clusters, block_t):
    """Soup tables with a mesh config's cluster count (Morton order: the
    plan needs the shapes, not kd cells)."""
    tab = TK.build_tri_tables(*_soup(n_clusters * block_t - block_t // 2), block_t=block_t,
                              view_origin=np.zeros(3), cluster_mode="morton")
    assert tab.cluster_aabbs.shape[0] >= n_clusters
    return tab


def _spherefield():
    scene = compile_scene_file(SCENES / "spherefield10k.pbrt")
    sph = scene.spheres
    return TS.build_sphere_tables(sph.w2o, sph.o2w, sph.radius, sph.prim,
                                  view_origin=np.asarray(scene.camera.camera_to_world)[:3, 3])


@pytest.mark.parametrize("case", ["cornell-bt8", "mesh10k-160", "mesh100k-1792", "mesh600k-4.7k",
                                  "spherefield10k-136"])
def test_launch_plan(case):
    """The small-table walk for the Cornell tables (8 rows a cluster), the
    warp walk for tables with the mesh configs' cluster counts (supers, 7
    slabs at mesh100k, 128-row clusters at mesh600k) and for the sphere
    field's own tables (64 spheres a cluster, supers, one slab)."""
    tab = {"cornell-bt8": _cornell,
           "mesh10k-160": lambda: _mesh_like(160, 64),
           "mesh100k-1792": lambda: _mesh_like(1737, 64),
           "mesh600k-4.7k": lambda: _mesh_like(4688, 128),
           "spherefield10k-136": _spherefield}[case]()
    nc = tab.cluster_aabbs.shape[0]
    want = {
        "cornell-bt8": (8, False, 1, "small"),
        "mesh10k-160": (64, True, 1, "warp"),
        "mesh100k-1792": (64, True, 7, "warp"),
        "mesh600k-4.7k": (128, True, 19, "warp"),
        "spherefield10k-136": (64, True, 1, "warp"),
    }[case]
    if case.startswith("sphere"):
        plan = TK.launch_plan(tab.block_s)
        assert (tab.block_s, tab.use_supers, tab.slab_aabbs.shape[0], plan) == want
        assert TS.DeviceSphereTables(tab, "cpu").plan == plan
        assert nc == 136 and int((tab.row_sphere >= 0).sum()) == 8556
        return
    plan = TK.launch_plan(tab.block_t)
    assert (tab.block_t, tab.use_supers, tab.n_slabs, plan) == want
    assert TK.DeviceTables(tab, "cpu").plan == plan
    if case == "cornell-bt8":
        assert nc < 16 and tab.block_t <= TK.SMALL_MAX_BLOCK_T
    if case == "mesh100k-1792":
        assert nc == 1792
    if case == "mesh600k-4.7k":
        assert 4_700 < nc < 5_000


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Every wrapper, on every device, refuses what no kernel takes: inputs
    not float32, a primitive table of the wrong row count, supers over
    slabs that are not whole supers, block_t below 1; misaligned views are
    copied."""
    o, d, t_max, p0, p1, p2 = _scene(0, 8, 48, 2.0)
    tab = TK.build_tri_tables(p0, p1, p2, np.arange(48, dtype=np.int32), block_t=8)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (o, d, t_max, tab.tris16, tab.cluster_aabbs, tab.super_aabbs, tab.slab_aabbs)]
    kw = dict(block_t=8, clusters_per_slab=tab.clusters_per_slab, use_supers=False)
    bad = [
        (TypeError, "float32", [a.double() if i == 0 else a for i, a in enumerate(args)], kw),
        (ValueError, "primitive table", [a[:-1] if i == 3 else a for i, a in enumerate(args)],
         kw),
        (ValueError, "use_supers", args, dict(kw, use_supers=True)),
        (ValueError, "block_t", args, dict(kw, block_t=0)),
    ]
    for fn in (TK.tri_closest_hit_tables, TK.tri_any_hit_tables, TK.tri_closest_hit_warp,
               TK.tri_any_hit_warp):
        fn(*args, **kw)  # the tables themselves are taken
        for err, match, a, k in bad:
            with pytest.raises(err, match=match):
                fn(*a, **k)
    view = torch.arange(17, dtype=torch.float32)[1:].view(4, 4)
    assert view.data_ptr() % 16 != 0
    fixed = TK._aligned(view)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, view)


@pytest.mark.parametrize("live", [0, 112_927, 4_194_304], ids=["all-dead", "mesh100k-b2", "all-live"])
def test_bound_counts_a_dead_ray_by_its_t_max(live):
    """The bound reads a live ray's o, d and t_max (28 B) and a dead ray's
    t_max alone (4 B): a dead ray's result needs nothing else. At mesh100k's
    bounce-2 shape (112,927 of 4,194,304 rays live) K1's bytes are ~4x
    fewer than with every ray read whole."""
    n, tab_b = 4_194_304, 7_340_032
    ms, by = bound(n, live, 8, tab_b, 0, 64, 84)
    n_bytes = live * 28 + (n - live) * 4 + n * 8 + tab_b
    assert by == "bytes" and ms == pytest.approx(n_bytes / HBM_BYTES_PER_S * 1e3, rel=1e-12)
    whole, _ = bound(n, n, 8, tab_b, 0, 64, 84)
    assert ms <= whole and (live < n) == (ms < whole)
    if live == 112_927:
        assert 0.25 < ms / whole < 0.4
    ms_ops, by_ops = bound(n, live, 8, tab_b, 10**9, 64, 84)  # a billion tiles: operations
    assert by_ops == "operations" and ms_ops > ms


def test_every_entry_point_is_defined_once():
    """The C signatures build.py declares are exactly the extern "C" entry
    points of csrc/*.cu, each defined in one source."""
    defined = []
    for src in sorted(build.CSRC.glob("*.cu")):
        defined += re.findall(r'extern "C" int (\w+)\(', src.read_text())
    assert sorted(defined) == sorted(build.ENTRY_POINTS)


def test_forced_walks_are_the_plain_versions_on_the_cpu():
    o, d, t_max, p0, p1, p2 = _scene(1, 64, 300, 2.0)
    tab = _tables(p0, p1, p2, 64, 256, None)
    dev = TK.DeviceTables(tab, "cpu")
    o, d, t_max = (torch.from_numpy(a) for a in (o, d, t_max))
    before = dict(TK.LAUNCHES)
    assert all(torch.equal(x, y) for x, y in zip(dev.closest(o, d, t_max),
                                                 dev.closest_warp(o, d, t_max)))
    assert torch.equal(dev.any_hit(o, d, t_max), dev.any_hit_warp(o, d, t_max))
    assert TK.LAUNCHES == before  # plain-version calls are not launches


def test_forced_sphere_walks_are_the_plain_versions_on_the_cpu():
    o, d, t_max, arrays = _sphere_scene(2, 64, 300)
    dev = TS.DeviceSphereTables(_sphere_tables(arrays, 64, 256, None), "cpu")
    o, d, t_max = (torch.from_numpy(a) for a in (o, d, t_max))
    args = (o, d, t_max, dev.sph16, dev.caabb, dev.saabb, dev.slab_aabb)
    t_p, r_p = TS.sphere_closest_hit_plain(*args, **dev.kw)
    h_p = TS.sphere_any_hit_plain(*args, **dev.kw)
    assert int((r_p >= 0).sum()) > 5
    before = dict(TK.LAUNCHES)
    for walk in ("", "_warp"):
        t, r = getattr(dev, "closest" + walk)(o, d, t_max)
        assert torch.equal(t.view(torch.int32), t_p.view(torch.int32)) and torch.equal(r, r_p)
        assert torch.equal(getattr(dev, "any_hit" + walk)(o, d, t_max), h_p)
    for fn in (TS.sphere_closest_hit_tables, TS.sphere_closest_hit_warp):
        assert all(torch.equal(x, y) for x, y in zip(fn(*args, **dev.kw), (t_p, r_p)))
    for fn in (TS.sphere_any_hit_tables, TS.sphere_any_hit_warp):
        assert torch.equal(fn(*args, **dev.kw), h_p)
    assert TK.LAUNCHES == before  # plain-version calls are not launches


# ---------------------------------------------------------------------------
# the rehearsal


def warp_min(lanes, neg_zero, width=WARP):
    """The card's reduction of the lanes' (t, row) (warp_min,
    csrc/intersect_warp.cu): the least key — t's float32 bits, with the sign
    bit cleared where the test can return -0.0 (neg_zero: spheres), which
    orders t >= -0.0 as floats and ties -0.0 with +0.0 — then the least row
    among the lanes that hold it; t is the key's float (triangles: t > 0) or
    comes from that row's own lane, its sign included (spheres)."""
    mask = 0x7FFFFFFF if neg_zero else 0xFFFFFFFF
    keys = [int(np.float32(t).view(np.uint32)) & mask for t, _ in lanes]
    k_min = min(keys)
    row = min(r for k, (_, r) in zip(keys, lanes) if k == k_min)
    t = lanes[row % width][0] if neg_zero else float(np.uint32(k_min).view(np.float32))
    return t, row


def warp_walk(o, d, t_max, tab, width=WARP):
    """The schedule of csrc/intersect_warp.cu, one ray at a time, in plain
    PyTorch, over TriTables (the watertight test) or SphereTables (the
    sphere test). Returns (t, row, entered, improved, any-hit, re-tests)."""
    neg_zero = isinstance(tab, TS.SphereTables)
    if neg_zero:
        prims, block = tab.sph16, tab.block_s

        def test(rows, i, bound):
            return TS._sphere_tile_test(rows, o[i:i + 1], d[i:i + 1], bound)[0]
    else:
        prims, block = tab.tris16, tab.block_t
        kz, sx, sy, sz = TK.ray_shear(d)

        def test(rows, i, bound):
            return TK._tile_test(rows, o[i:i + 1], kz[i:i + 1], sx[i:i + 1], sy[i:i + 1],
                                 sz[i:i + 1], bound)[0]
    prims, caabb, saabb, slab = (torch.from_numpy(np.ascontiguousarray(a)) for a in (
        prims, tab.cluster_aabbs, tab.super_aabbs, tab.slab_aabbs))
    cps, n_slabs = tab.clusters_per_slab, slab.shape[0]
    n_sup = cps // TK.SUPER_G
    inv_d = 1.0 / torch.where(d == 0, 1e-30, d)
    n = o.shape[0]
    t_out = torch.full((n,), FMAX)
    row_out = torch.full((n,), -1, dtype=torch.int32)
    entered = torch.zeros((n,), dtype=torch.int32)
    improved = torch.zeros_like(entered)
    hit_out = torch.zeros((n,), dtype=torch.bool)
    retests = 0
    for i in range(n):
        if not bool(t_max[i] > 0):  # a dead ray is written without a walk
            continue
        ray = (o[i:i + 1], inv_d[i:i + 1])
        tile = lambda c, bound: test(prims[c * block:(c + 1) * block], i, bound)  # noqa: E731

        def walk(bound, visit):
            def level(boxes, first, count, visit):
                nonlocal retests
                for base in range(0, count, width):
                    b0 = bound().clone()
                    cand = [first + base + lane for lane in range(min(width, count - base))
                            if bool(TK._box_enter(boxes[first + base + lane], *ray, b0))]
                    for c in cand:  # in table order
                        if not torch.equal(bound(), b0):  # the bound shrank: re-test
                            retests += 1
                            if not bool(TK._box_enter(boxes[c], *ray, bound())):
                                continue
                        if visit(c):
                            return True
                return False

            def in_slab(j):
                if tab.use_supers:
                    return level(saabb, j * n_sup, n_sup,
                                 lambda s: level(caabb, s * TK.SUPER_G, TK.SUPER_G, visit))
                return level(caabb, j * cps, cps, visit)

            if n_slabs > 1:
                level(slab, 0, n_slabs, in_slab)
            else:
                in_slab(0)

        best = {"t": t_max[i:i + 1].clone(), "idx": -1}

        def closest_visit(c):
            entered[i] += 1
            frozen = best["t"].clone()
            t = tile(c, frozen).tolist()  # float32 values, -0.0 kept
            lanes = [(FMAX, 0)] * width  # per lane: its smallest t, lowest row first
            for row, tr in enumerate(t):
                if tr < lanes[row % width][0]:
                    lanes[row % width] = (tr, row)
            bt, br = warp_min(lanes, neg_zero, width)
            f = float(frozen)
            if bt < f or (bt == f and best["idx"] < 0 and bt < FMAX):
                best["t"] = torch.tensor([bt], dtype=torch.float32)
                best["idx"] = c * block + br
                improved[i] += 1
            return False

        walk(lambda: best["t"], closest_visit)
        if best["idx"] >= 0:
            t_out[i], row_out[i] = best["t"][0], best["idx"]
        hit = [False]

        def any_visit(c):
            hit[0] = bool((tile(c, t_max[i:i + 1]) < FMAX).any())  # -0.0 is a hit
            return hit[0]

        walk(lambda: t_max[i:i + 1], any_visit)
        hit_out[i] = hit[0]
    return t_out, row_out, entered, improved, hit_out, retests


REHEARSAL_CASES = [  # tests/test_torch_intersect_kernel.py's cases, more batches and shapes
    ("tri", 0, 37, 8, 256, None, "free"),
    ("tri", 1, 37, 64, 256, None, "free"),
    ("tri", 4, 300, 8, 256, None, "free"),
    ("tri", 2, 300, 64, 256, None, "free"),
    ("tri", 5, 900, 8, 16, True, "free"),
    ("tri", 3, 300, 8, 256, None, "t_max-tie"),
    ("tri", 6, 900, 64, 16, True, "dead90"),
    ("tri", 7, 2100, 128, 8, False, "free"),
    ("tri", 8, 900, 32, 16, True, "free"),
    ("tri", 9, 2100, 128, 8, False, "dead90"),
    ("tri", 10, 300, 64, 256, None, "t_max-tie"),
    # spheres: the sphere field's layout (64 rows, supers, one slab; supers
    # need more than 8 clusters, so 576 spheres), supers over several slabs
    # with NaN padding clusters, the t_max tie, ~90% dead lanes, and rays
    # that start on a sphere's surface (t = -0.0)
    ("sphere", 11, 576, 64, 256, True, "free"),
    ("sphere", 12, 300, 16, 16, True, "free"),
    ("sphere", 13, 300, 64, 256, None, "t_max-tie"),
    ("sphere", 14, 576, 64, 256, True, "dead90"),
    ("sphere", 15, 70, 64, 256, None, "on-surface"),
]


@pytest.mark.parametrize(
    "prim,seed,n_prims,block,cps,use_supers,batch", REHEARSAL_CASES,
    ids=["37tri-bt8", "37tri-bt64", "300tri-bt8", "300tri-bt64", "900tri-supers-slabs",
         "t_max-tie", "dead90-supers-slabs", "2100tri-bt128-slabs", "900tri-bt32-supers-slabs",
         "dead90-bt128-slabs", "t_max-tie-bt64", "576sph-bs64-supers", "300sph-bs16-supers-slabs",
         "sph-t_max-tie", "sph-dead90-supers", "sph-on-surface"])
def test_rehearsal_of_the_warp_schedule(prim, seed, n_prims, block, cps, use_supers, batch):
    """The warp walk's schedule gives the plain version's (t, row, entered,
    improved) and any-hit exactly, t's bits included: 32 lanes on 8-row
    clusters (24 idle), on 16 and 32 rows, on 64 (two rows a lane, the
    sphere field's tables) and 128. Batches: t_max free (100); t_max equal
    to each ray's own closest hit t (the first-hit-at-t_max rule); ~90%
    dead lanes; rays starting on a sphere's surface, whose hits are ±0.0."""
    if prim == "tri":
        o, d, t_max, p0, p1, p2 = _scene(seed, 192, n_prims,
                                         spread=2.0 if n_prims < 900 else 4.0)
        tab = _tables(p0, p1, p2, block, cps, use_supers)
        args = (tab.tris16, tab.cluster_aabbs, tab.super_aabbs, tab.slab_aabbs)
        kw = dict(block_t=block, clusters_per_slab=tab.clusters_per_slab,
                  use_supers=tab.use_supers)
        closest, any_hit = TK.tri_closest_hit_plain, TK.tri_any_hit_plain
    else:
        o, d, t_max, arrays = (_on_surface(seed, 192) if batch == "on-surface"
                               else _sphere_scene(seed, 192, n_prims))
        tab = _sphere_tables(arrays, block, cps, use_supers)
        args = (tab.sph16, tab.cluster_aabbs, tab.super_aabbs, tab.slab_aabbs)
        kw = dict(block_s=block, clusters_per_slab=tab.clusters_per_slab,
                  use_supers=tab.use_supers)
        closest, any_hit = TS.sphere_closest_hit_plain, TS.sphere_any_hit_plain
        if cps == 16:
            assert tab.use_supers and tab.slab_aabbs.shape[0] > 1
            assert np.isnan(tab.cluster_aabbs[:, 0]).any()
        elif use_supers:
            assert tab.use_supers and tab.slab_aabbs.shape[0] == 1
    o, d, t_max = (torch.from_numpy(a) for a in (o, d, t_max))
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    if batch == "t_max-tie":
        t_free, _ = closest(o, d, torch.full_like(t_max, 100.0), *targs, **kw)
        t_max = torch.where(t_free < FMAX, t_free, 100.0)
    elif batch == "dead90":
        keep = torch.from_numpy(np.random.default_rng(seed).uniform(size=o.shape[0]) < 0.1)
        t_max = torch.where(keep, t_max, 0.0)
    t, row, ent, imp, hit, retests = warp_walk(o, d, t_max, tab)
    tp, rp, ep, ip = closest(o, d, t_max, *targs, **kw, stats=True)
    hp = any_hit(o, d, t_max, *targs, **kw)
    assert torch.equal(t.view(torch.int32), tp.view(torch.int32))  # bit for bit, sign included
    assert torch.equal(row, rp)  # the same tie rule, so rows are equal outright
    assert torch.equal(ent, ep) and torch.equal(imp, ip)
    assert torch.equal(hit, hp)
    assert int((rp >= 0).sum()) > (0 if batch == "dead90" else 5)
    if batch == "t_max-tie":
        # the rule fires for most rays (for every sphere hit); the watertight
        # range test, which compares t_scaled with t_max·det in other
        # roundings, rejects a few triangle hits
        ties = int((t_max < 100.0).sum())
        assert int((rp >= 0).sum()) >= (ties if prim == "sphere" else 0.75 * ties)
    if batch == "free" and n_prims >= 300:
        assert retests > 0  # candidates were re-tested against a shrunk bound
    if batch == "on-surface":
        # every live ray hits the unit sphere at ±0; those that leave it at
        # -0.0, whose raw bits would order above FLT_MAX's
        live = t_max > 0
        assert torch.equal(rp >= 0, live) and bool((tp[live] == 0).all())
        assert int((torch.signbit(tp) & live).sum()) > 20
