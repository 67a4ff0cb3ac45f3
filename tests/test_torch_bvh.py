"""The port's flat BVH (curry_pbrt_tpu_torch/ops/bvh.py, ops/bvh_native.py,
ops/kernels/bvh_kernel.py) against the JAX package's ops/bvh.py, and the
mirrors of tests/test_bvh.py, tests/test_bvh_builders.py and
tests/test_golden.py's bvh-against-brute render.

Tolerances:
  - the built arrays (bounds, links, leaf ranges, prim_refs) are the JAX
    package's EXACTLY, for its native and its numpy builder alike (the JAX
    package's numpy builder runs when its native one is monkeypatched out);
  - traversal (t, ref) against JAX bvh_traverse on the same arrays: hit
    masks equal, t within rtol 1e-5 (XLA's CPU lowering contracts a*b+c into
    FMAs and maps rays into sphere space by an einsum; the port rounds each
    op separately, in _mat3_vec's fixed order: a few ULPs), refs equal
    wherever the two t agree to 1e-6 relative and the winning t is unique;
  - the mirrored tests keep their own tolerances (t rtol 1e-5, p rtol 1e-4
    atol 1e-5, n atol 1e-5 against the brute oracle; images rtol = atol =
    1e-4).
The walk on the card against its plain version is
tests/test_torch_bvh_card.py (no JAX import: it runs beside the card).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curry_pbrt_tpu.dtypes import FLOAT_MAX
from curry_pbrt_tpu.ops import bvh as JB
from curry_pbrt_tpu.ops import bvh_native as jax_native
from curry_pbrt_tpu.ops.intersect import TriangleArrays as JaxTris
from curry_pbrt_tpu.ops.intersect import empty_spheres as jax_empty_spheres
from curry_pbrt_tpu.sceneio.compiler import compile_scene_string as jax_compile_string
from curry_pbrt_tpu_torch.ops import bvh as PB
from curry_pbrt_tpu_torch.ops import bvh_native
from curry_pbrt_tpu_torch.ops import intersect as isect
from curry_pbrt_tpu_torch.ops.kernels import bvh_kernel as BK
from curry_pbrt_tpu_torch.ops.kernels import intersect_kernel as TK
from curry_pbrt_tpu_torch.render import make_intersectors, render_scene
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file, compile_scene_string
from tests.test_bvh import random_tri_scene

REPO = Path(__file__).resolve().parents[1]
FIELDS = ("bmin", "bmax", "hit", "miss", "first", "count", "prim_refs")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (see tests/test_torch_grad.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scene_text(n_tris=64, n_spheres=4, seed=0):
    """tests/test_bvh.py's random soup, as scene text both compilers read."""
    rng = np.random.RandomState(seed)
    lines = [
        'Film "image" "integer xresolution" [8] "integer yresolution" [8]',
        'Sampler "halton" "integer pixelsamples" [1]',
        'Camera "perspective" "float fov" [60]',
        'Integrator "path" "integer maxdepth" [2]',
        "WorldBegin",
        'Material "matte"',
    ]
    pts, idx = [], []
    for i in range(n_tris):
        c = rng.rand(3) * 8 - 4 + np.array([0, 0, 8])
        v = c[None, :] + rng.randn(3, 3) * 0.7
        pts.extend(v.reshape(-1))
        idx.extend([3 * i, 3 * i + 1, 3 * i + 2])
    if n_tris:
        lines.append('Shape "trianglemesh" "integer indices" [%s] "point P" [%s]'
                     % (" ".join(map(str, idx)), " ".join("%.5f" % x for x in pts)))
    for _ in range(n_spheres):
        c = rng.rand(3) * 8 - 4 + np.array([0, 0, 8])
        lines += ["AttributeBegin", "Translate %.4f %.4f %.4f" % tuple(c),
                  'Shape "sphere" "float radius" [%.4f]' % (0.3 + rng.rand()), "AttributeEnd"]
    lines.append("WorldEnd")
    return "\n".join(lines)


def both_scenes(seed, n_tris=64, n_spheres=4):
    text = scene_text(n_tris, n_spheres, seed)
    return (jax_compile_string(text, overrides={"clip": False}),
            compile_scene_string(text, overrides={"clip": False}))


def random_rays(n, seed):
    """tests/test_bvh.py's random_rays, as numpy."""
    rng = np.random.RandomState(seed)
    o = (rng.rand(n, 3) * 16 - 8 + np.array([0, 0, 8])).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, np.full((n,), FLOAT_MAX, np.float32)


def tensors(arrays):
    return type(arrays)(*(torch.as_tensor(np.ascontiguousarray(a)) for a in arrays))


def intersectors(scene):
    bvh = PB.device_bvh(PB.build_flat_bvh(scene), scene.tris, scene.spheres, "cpu")
    return bvh, BK.make_bvh_intersectors(bvh, tensors(scene.tris), tensors(scene.spheres))


def jax_build(jscene, builder, monkeypatch):
    """The JAX package's flat BVH from its "native" or its "numpy" builder."""
    with monkeypatch.context() as m:
        if builder == "numpy":
            m.setattr(jax_native, "sah_build_flat", lambda *a, **k: None)
        return JB.build_flat_bvh(jscene)


def jax_tri_scene(p0, p1, p2):
    jscene = type("S", (), {})()
    jscene.tris = JaxTris(jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(p2),
                          jnp.arange(len(p0), dtype=jnp.int32))
    jscene.spheres = jax_empty_spheres()
    return jscene


def assert_arrays_equal_jax(pb, jb):
    assert pb.n_tris == jb.n_tris
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(pb, f), np.asarray(getattr(jb, f)), err_msg=f)


# ---------------------------------------------------------------------------
# against the JAX package


@pytest.mark.parametrize("builder", ["native", "numpy"])
@pytest.mark.parametrize("seed,n_tris,n_spheres", [(0, 64, 4), (7, 700, 40), (9, 0, 30)])
def test_flat_bvh_arrays_equal_jax(builder, seed, n_tris, n_spheres, monkeypatch):
    """The port's native build against the JAX package's `builder`."""
    js, ps = both_scenes(seed, n_tris, n_spheres)
    assert_arrays_equal_jax(PB.build_flat_bvh(ps), jax_build(js, builder, monkeypatch))


def test_empty_scene_builds_one_end_node():
    """No valid primitive: one node whose links are END, as in the JAX package."""
    z = np.zeros((0, 3), np.float32)
    pb = PB.build_flat_bvh(_FakeScene(z, z, z))
    jb = JB.build_flat_bvh(jax_tri_scene(z, z, z))
    assert pb.n_nodes == 1 and pb.hit[0] == pb.miss[0] == PB.END
    assert_arrays_equal_jax(pb, jb)
    bvh = PB.device_bvh(pb, _FakeScene(z, z, z).tris, _FakeScene(z, z, z).spheres, "cpu")
    o, d, t_max = map(torch.from_numpy, random_rays(64, 8))
    t, ref = BK.bvh_closest(bvh, o, d, t_max)
    assert (ref < 0).all() and torch.equal(t, t_max)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_bvh_traverse_matches_jax(seed, any_hit):
    js, ps = both_scenes(seed, 200, 12)
    jb = JB.build_flat_bvh(js)
    pbvh = PB.device_bvh(PB.build_flat_bvh(ps), ps.tris, ps.spheres, "cpu")
    o, d, t_max = random_rays(1024, seed + 40)
    t_max[::5] = 6.0  # some bounded rays
    tj, rj = JB.bvh_traverse(jb, js.tris, js.spheres, jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(t_max), any_hit=any_hit)
    tp, rp = PB.bvh_traverse(pbvh, *map(torch.from_numpy, (o, d, t_max)), any_hit=any_hit)
    tj, rj, tp, rp = np.asarray(tj), np.asarray(rj), tp.numpy(), rp.numpy()
    np.testing.assert_array_equal(rj >= 0, rp >= 0)
    assert (rp >= 0).sum() > 100
    np.testing.assert_allclose(tp, tj, rtol=1e-5)
    if not any_hit:
        same_t = np.isclose(tp, tj, rtol=1e-6, atol=0)
        assert (rp[same_t] == rj[same_t]).mean() > 0.99


def test_the_native_builder_is_the_jax_packages_source():
    """The port's copy is native/bvh_builder.cpp line for line once the //
    comments and the lines they leave empty are dropped (its header
    comment names its own build)."""

    def code(path):
        lines = (line.split("//")[0].rstrip() for line in path.read_text().splitlines())
        return [line for line in lines if line]

    a = code(REPO / "native" / "bvh_builder.cpp")
    b = code(REPO / "curry_pbrt_tpu_torch" / "csrc" / "bvh_builder.cpp")
    assert a == b and len(a) > 150


def test_native_builder_raises_when_it_cannot_build(tmp_path, monkeypatch):
    """No fallback: a failed build is an error."""
    monkeypatch.setattr(bvh_native, "BUILD_DIR", tmp_path / "bvh")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    bvh_native.load_library.cache_clear()
    try:
        _, ps = both_scenes(0, 8, 1)
        with pytest.raises(RuntimeError, match="native BVH builder|failed"):
            PB.build_flat_bvh(ps)
    finally:
        bvh_native.load_library.cache_clear()


def test_wrappers_use_the_plain_version_on_the_cpu():
    """CPU tensors: the plain version, and no launch is counted."""
    _, ps = both_scenes(3, 50, 5)
    bvh, _ = intersectors(ps)
    o, d, t_max = map(torch.from_numpy, random_rays(256, 3))
    before = dict(TK.LAUNCHES)
    t, ref = BK.bvh_closest(bvh, o, d, t_max)
    hit = BK.bvh_any(bvh, o, d, t_max)
    assert TK.LAUNCHES == before
    t_p, ref_p = PB.bvh_traverse(bvh, o, d, t_max)
    assert torch.equal(t, t_p) and torch.equal(ref, ref_p)
    assert torch.equal(hit, ref_p >= 0)
    with pytest.raises(ValueError, match="rays"):
        BK.bvh_closest(bvh, o[:, :2], d, t_max)


def test_dead_lanes_report_no_hit():
    """t_max 0 (an integrator's dead lane) walks nothing: t stays 0."""
    _, ps = both_scenes(4, 64, 4)
    bvh, _ = intersectors(ps)
    o, d, t_max = random_rays(256, 5)
    t_max[::2] = 0.0
    t, ref = PB.bvh_traverse(bvh, *map(torch.from_numpy, (o, d, t_max)))
    assert (ref[::2] < 0).all() and (t[::2] == 0).all()
    assert (ref[1::2] >= 0).any()


# ---------------------------------------------------------------------------
# mirrors of tests/test_bvh.py


class TestBVHEquivalence:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_closest_hit_matches_brute(self, seed):
        _, ps = both_scenes(seed)
        _, (inter, _pred, _tprim) = intersectors(ps)
        o, d, t = map(torch.from_numpy, random_rays(512, seed + 10))
        hb = isect.intersect_brute(o, d, t, tensors(ps.tris), tensors(ps.spheres))
        hv = inter(o, d, t)
        np.testing.assert_array_equal(hb.prim.numpy(), hv.prim.numpy())
        sel = hb.valid.numpy()
        np.testing.assert_allclose(hb.t.numpy()[sel], hv.t.numpy()[sel], rtol=1e-5)
        np.testing.assert_allclose(hb.p.numpy()[sel], hv.p.numpy()[sel], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(hb.n.numpy()[sel], hv.n.numpy()[sel], atol=1e-5)

    def test_predicate_matches_brute(self):
        _, ps = both_scenes(3)
        _, (_inter, pred, _tprim) = intersectors(ps)
        o, d, t = map(torch.from_numpy, random_rays(512, 20))
        pb = isect.intersect_predicate_brute(o, d, t, tensors(ps.tris), tensors(ps.spheres))
        np.testing.assert_array_equal(pb.numpy(), pred(o, d, t).numpy())

    def test_t_max_respected(self):
        _, ps = both_scenes(4)
        _, (inter, _pred, tprim) = intersectors(ps)
        o, d, _ = map(torch.from_numpy, random_rays(256, 30))
        t = torch.full((256,), 2.0)
        hb = isect.intersect_brute(o, d, t, tensors(ps.tris), tensors(ps.spheres))
        np.testing.assert_array_equal(hb.prim.numpy(), inter(o, d, t).prim.numpy())
        np.testing.assert_array_equal(hb.prim.numpy(), tprim(o, d, t)[1].numpy())

    def test_structure_sane(self):
        _, ps = both_scenes(5)
        bvh = PB.build_flat_bvh(ps)
        hit, miss, first, count = bvh.hit, bvh.miss, bvh.first, bvh.count
        M = bvh.n_nodes
        assert np.all(hit < M) and np.all(miss < M)
        assert np.all(hit >= -1) and np.all(miss >= -1)
        leaves = first >= 0
        slots = []
        for f, c in zip(first[leaves], count[leaves]):
            slots.extend(range(f, f + c))
        n_prims = int((ps.tris.prim >= 0).sum()) + int((ps.spheres.prim >= 0).sum())
        assert sorted(slots) == list(range(n_prims))
        assert np.all((hit > np.arange(M)) | (hit == -1))
        assert np.all((miss > np.arange(M)) | (miss == -1))


def test_the_soup_scene_of_test_bvh_compiles_alike():
    """The JAX test's own scene generator and this file's agree."""
    js = random_tri_scene(seed=2)
    jt, _ = both_scenes(2)
    np.testing.assert_array_equal(np.asarray(js.tris.p0), np.asarray(jt.tris.p0))


# ---------------------------------------------------------------------------
# mirrors of tests/test_bvh_builders.py


def _random_tris(n, seed, spread=10.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    p0 = base
    p1 = base + rng.normal(0, 0.8, (n, 3)).astype(np.float32)
    p2 = base + rng.normal(0, 0.8, (n, 3)).astype(np.float32)
    return p0, p1, p2


class _FakeScene:
    def __init__(self, p0, p1, p2):
        self.tris = isect.TriangleArrays(p0, p1, p2, np.arange(p0.shape[0], dtype=np.int32))
        z44 = np.zeros((0, 4, 4), np.float32)
        self.spheres = isect.SphereArrays(z44, z44, np.zeros((0,), np.float32),
                                          np.zeros((0,), np.int32))


def _check_structure(bvh, n_prims):
    hit, miss, first, count = bvh.hit, bvh.miss, bvh.first, bvh.count
    M = bvh.n_nodes
    assert hit.min() >= -1 and hit.max() < M
    assert miss.min() >= -1 and miss.max() < M
    ptr, steps = 0, 0
    while ptr != -1 and steps <= M:
        ptr = hit[ptr]
        steps += 1
    assert ptr == -1, "hit-link cycle"
    leaf = first >= 0
    slots = np.concatenate([np.arange(f, f + c) for f, c in zip(first[leaf], count[leaf])])
    assert sorted(slots.tolist()) == list(range(n_prims))
    assert sorted(bvh.prim_refs.tolist()) == list(range(n_prims))


@pytest.mark.parametrize("n", [10, 257, 5000])
def test_native_and_numpy_builders_traverse_identically(n, monkeypatch):
    """The port's native build is both JAX builders' arrays, exactly, and
    its walk finds what the JAX package's walk finds over the JAX numpy
    builder's BVH (t within rtol 1e-5, as in test_bvh_traverse_matches_jax)."""
    p0, p1, p2 = _random_tris(n, seed=n)
    scene = _FakeScene(p0, p1, p2)
    native = PB.build_flat_bvh(scene)
    _check_structure(native, n)
    jscene = jax_tri_scene(p0, p1, p2)
    for builder in ("native", "numpy"):
        assert_arrays_equal_jax(native, jax_build(jscene, builder, monkeypatch))
    numpy_bvh = jax_build(jscene, "numpy", monkeypatch)

    rng = np.random.default_rng(99)
    o_np = rng.uniform(-15, 15, (256, 3)).astype(np.float32)
    cent = ((p0 + p1 + p2) / 3.0)[rng.integers(0, len(p0), 128)]
    d_np = rng.normal(0, 1, (256, 3)).astype(np.float32)
    d_np[:128] = cent - o_np[:128]
    d_np /= np.linalg.norm(d_np, axis=-1, keepdims=True)
    o, d = torch.from_numpy(o_np), torch.from_numpy(d_np)
    t_max = torch.full((256,), 1e30)

    dev = PB.device_bvh(native, scene.tris, scene.spheres, "cpu")
    tn, id_n = (x.numpy() for x in BK.bvh_closest(dev, o, d, t_max))
    tp, id_p = (np.asarray(x) for x in JB.bvh_traverse(
        numpy_bvh, jscene.tris, jscene.spheres, jnp.asarray(o_np), jnp.asarray(d_np),
        jnp.asarray(t_max.numpy())))
    hit_mask = id_n >= 0
    np.testing.assert_array_equal(hit_mask, id_p >= 0)
    np.testing.assert_allclose(tn[hit_mask], tp[hit_mask], rtol=1e-5)
    assert hit_mask.any()
    close = np.isclose(tn, tp, rtol=1e-6)
    assert (id_n[hit_mask & close] == id_p[hit_mask & close]).mean() > 0.99


def test_numpy_builder_deep_chained_leaves(monkeypatch):
    """Clustered prims force oversized SAH leaves → chained fixed-width leaf
    nodes (5k prims also take the JAX numpy builder through its
    recursion-limit bump): the port's build is both JAX builders' arrays."""
    rng = np.random.default_rng(5)
    centers = rng.uniform(-50, 50, (10, 3))
    base = (centers[rng.integers(0, 10, 5000)] + rng.normal(0, 0.01, (5000, 3))).astype(np.float32)
    p1 = base + rng.normal(0, 0.02, (5000, 3)).astype(np.float32)
    p2 = base + rng.normal(0, 0.02, (5000, 3)).astype(np.float32)
    bvh = PB.build_flat_bvh(_FakeScene(base, p1, p2))
    _check_structure(bvh, 5000)
    assert int(bvh.count.max()) <= PB.LEAF_SIZE
    jscene = jax_tri_scene(base, p1, p2)
    for builder in ("native", "numpy"):
        assert_arrays_equal_jax(bvh, jax_build(jscene, builder, monkeypatch))


# ---------------------------------------------------------------------------
# end to end (tests/test_golden.py's bvh against brute)


def test_bvh_matches_brute_end_to_end():
    scene = compile_scene_file(REPO / "scenes" / "cornell.pbrt",
                               overrides={"resolution": (32, 32), "spp": 2, "max_depth": 2})
    a = render_scene(scene, device="cpu", show_progress=False, intersector="brute")
    b = render_scene(scene, device="cpu", show_progress=False, intersector="bvh")
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_make_intersectors_knows_bvh():
    scene = compile_scene_file(REPO / "scenes" / "cornell.pbrt",
                               overrides={"resolution": (4, 4), "spp": 1, "max_depth": 1})
    assert len(make_intersectors(scene, "cpu", "bvh")) == 3
    with pytest.raises(ValueError, match="intersector"):
        make_intersectors(scene, "cpu", "octree")


@pytest.mark.parametrize("builder", ["native", "numpy"])
def test_oversize_leaves_chain_as_jax(builder, monkeypatch):
    """Eleven copies of one triangle: no SAH split pays, so the leaf holds
    all eleven and is flattened into chained pieces of 4, 4 and 3 with the
    same bounds, hit = miss = the next piece — the arrays of the JAX
    package's `builder`."""
    rng = np.random.default_rng(11)
    one = rng.uniform(-1, 1, (3, 3)).astype(np.float32)
    others = rng.uniform(-9, 9, (5, 3, 3)).astype(np.float32)
    tris = np.concatenate([np.repeat(one[None], 11, axis=0), others])
    p0, p1, p2 = (np.ascontiguousarray(tris[:, k]) for k in range(3))
    scene = _FakeScene(p0, p1, p2)
    bvh = PB.build_flat_bvh(scene)
    pieces = [i for i in range(bvh.n_nodes - 1)
              if bvh.first[i] >= 0 and bvh.hit[i] == bvh.miss[i] == i + 1
              and (bvh.bmin[i] == bvh.bmin[i + 1]).all() and bvh.count[i] == PB.LEAF_SIZE]
    assert len(pieces) >= 2
    assert_arrays_equal_jax(bvh, jax_build(jax_tri_scene(p0, p1, p2), builder, monkeypatch))


# ---------------------------------------------------------------------------
# the node rows of the live-ray walk (ops/bvh.py pack_nodes)


def _mesh10k_subsample(scene):
    """Every third triangle of mesh10k and its spheres."""
    t = scene.tris
    sub = isect.TriangleArrays(*(np.ascontiguousarray(np.asarray(a)[::3])
                                 for a in (t.p0, t.p1, t.p2, t.prim)))
    return type("S", (), {"tris": sub, "spheres": scene.spheres})()


@pytest.fixture(scope="module")
def flat_bvhs():
    """The builder's BVH of cornell, spheres, the sphere field and a mesh10k
    subsample."""
    def compiled(name):
        return compile_scene_file(REPO / "scenes" / f"{name}.pbrt",
                                  overrides={"resolution": (8, 8), "spp": 1})

    scenes = {name: compiled(name) for name in ("cornell", "spheres", "spherefield10k")}
    scenes["mesh10k/3"] = _mesh10k_subsample(compiled("mesh10k"))
    return {name: (sc, PB.build_flat_bvh(sc)) for name, sc in scenes.items()}


def _unpack_nodes(rows):
    """(bmin, bmax, miss, first, count) of (M, 8) node rows, as the walk of
    csrc/bvh_walk.cu decodes them."""
    bits = np.asarray(rows, np.float32).view(np.int32)
    packed = bits[:, 7]
    return (rows[:, 0:3], rows[:, 4:7], bits[:, 3], packed >> PB.COUNT_BITS,
            packed & ((1 << PB.COUNT_BITS) - 1))


SCENES = ["cornell", "spheres", "spherefield10k", "mesh10k/3"]


@pytest.mark.parametrize("name", SCENES)
def test_node_rows_round_trip(flat_bvhs, name):
    """The rows give back bounds (bit for bit), miss links and leaf ranges;
    device_bvh carries them as an (M, 8) float32 tensor."""
    sc, flat = flat_bvhs[name]
    rows = PB.pack_nodes(flat)
    assert rows.dtype == np.float32 and rows.shape == (flat.n_nodes, PB.NODE_COLS)
    bmin, bmax, miss, first, count = _unpack_nodes(rows)
    np.testing.assert_array_equal(bmin.view(np.int32), flat.bmin.view(np.int32))
    np.testing.assert_array_equal(bmax.view(np.int32), flat.bmax.view(np.int32))
    np.testing.assert_array_equal(miss, flat.miss)
    np.testing.assert_array_equal(first, flat.first)
    np.testing.assert_array_equal(count, flat.count)
    dev = PB.device_bvh(flat, sc.tris, sc.spheres, "cpu")
    assert dev.nodes.dtype == torch.float32
    np.testing.assert_array_equal(dev.nodes.numpy().view(np.int32), rows.view(np.int32))


@pytest.mark.parametrize("name", SCENES)
def test_builder_hit_links_are_implied(flat_bvhs, name):
    """The hit link the rows drop: the next node for an internal node, the
    miss link for a leaf piece."""
    _, flat = flat_bvhs[name]
    internal = flat.first < 0
    assert internal.any() or flat.n_nodes == 1
    implied = np.where(internal, np.arange(flat.n_nodes) + 1, flat.miss)
    np.testing.assert_array_equal(flat.hit, implied)


def _tiny_flat(**changes):
    """A hand-made three-node BVH: a root over two leaves (slots 0-1, 2-4)."""
    flat = PB.FlatBVH(bmin=np.zeros((3, 3), np.float32), bmax=np.ones((3, 3), np.float32),
                      hit=np.array([1, 2, -1], np.int32), miss=np.array([-1, 2, -1], np.int32),
                      first=np.array([-1, 0, 2], np.int32), count=np.array([0, 2, 3], np.int32),
                      prim_refs=np.arange(5, dtype=np.int32), n_tris=5)
    return flat._replace(**{k: np.asarray(v, np.int32) for k, v in changes.items()})


@pytest.mark.parametrize("changes,match", [
    (dict(hit=[2, 2, -1]), "internal node's hit link"),
    (dict(hit=[1, -1, -1]), "leaf's hit link"),
    (dict(first=[-1, 0, 2 ** 28]), "does not fit"),
    (dict(count=[0, 2, PB.LEAF_SIZE + 1]), "count"),
])
def test_pack_nodes_raises(changes, match):
    PB.pack_nodes(_tiny_flat())  # the unchanged BVH packs
    with pytest.raises(ValueError, match=match):
        PB.pack_nodes(_tiny_flat(**changes))


def test_leaf_pieces_of_count_zero_and_leaf_size_pack():
    """An empty leaf piece (count 0: the empty scene's one node) and full
    pieces (count LEAF_SIZE: eleven copies of one triangle, chained 4, 4, 3)
    decode to their own ranges; the largest first that fits packs too."""
    z = np.zeros((0, 3), np.float32)
    empty = PB.build_flat_bvh(_FakeScene(z, z, z))
    _, _, miss, first, count = _unpack_nodes(PB.pack_nodes(empty))
    assert (miss[0], first[0], count[0]) == (-1, 0, 0)
    one = np.random.default_rng(11).uniform(-1, 1, (3, 3)).astype(np.float32)
    p0, p1, p2 = (np.ascontiguousarray(np.repeat(one[None, k], 11, axis=0)) for k in range(3))
    chained = PB.build_flat_bvh(_FakeScene(p0, p1, p2))
    assert (chained.count == PB.LEAF_SIZE).sum() == 2
    _, _, miss, first, count = _unpack_nodes(PB.pack_nodes(chained))
    np.testing.assert_array_equal(count, chained.count)
    np.testing.assert_array_equal(first, chained.first)
    np.testing.assert_array_equal(miss, chained.miss)
    big = _tiny_flat(first=[-1, 2 ** 28 - 1, 2])
    _, _, _, first, count = _unpack_nodes(PB.pack_nodes(big))
    assert first[1] == 2 ** 28 - 1 and count[1] == 2


def _row_walk(bvh, o, d, t_max, any_hit=False):
    """The walk of csrc/bvh_walk.cu over the node rows alone, as a plain
    lockstep loop: the hit link of an entered internal node is ptr + 1, any
    other step follows the row's miss link."""
    rows = bvh.nodes
    bits = rows.view(torch.int32)
    t_out, ref_out = t_max.clone(), torch.full(t_max.shape, -1, dtype=torch.int32)
    inv_d = 1.0 / torch.where(d == 0, float(np.float32(1e-30)), d)
    shear = isect.ray_shear(d)
    lane = torch.nonzero(t_max > 0).squeeze(1)
    ptr = torch.zeros(lane.shape, dtype=torch.int64)
    while lane.numel():
        row, b = rows[ptr], bits[ptr]
        first, count = b[:, 7] >> PB.COUNT_BITS, b[:, 7] & ((1 << PB.COUNT_BITS) - 1)
        t_best, ref_best = t_out[lane], ref_out[lane]
        enter = PB._slab_test(row[:, 0:3], row[:, 4:7], o[lane], inv_d[lane], d[lane] < 0, t_best)
        for k in range(PB.LEAF_SIZE):
            at = torch.nonzero(enter & (first >= 0) & (k < count)).squeeze(1)
            if at.numel() == 0:
                break
            ref = bvh.prim_refs[(first[at] + k).long()]
            t_k, ok = PB._leaf_prim_test(bvh, ref, o[lane[at]], d[lane[at]],
                                         tuple(x[lane[at]] for x in shear), t_best[at])
            better = ok & (t_k < t_best[at])
            t_best[at] = torch.where(better, t_k, t_best[at])
            ref_best[at] = torch.where(better, ref, ref_best[at])
        nxt = torch.where(enter & (first < 0), ptr + 1, b[:, 3].long())
        if any_hit:
            nxt = torch.where(ref_best >= 0, -1, nxt)
        t_out[lane], ref_out[lane] = t_best, ref_best
        go = nxt >= 0
        lane, ptr = lane[go], nxt[go]
    return t_out, ref_out


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("name", ["spherefield10k", "mesh10k/3"])
def test_walk_over_node_rows_is_the_plain_traversal(flat_bvhs, name, any_hit):
    """The rows alone, decoded as the kernel decodes them, walk every ray as
    the plain version over the separate arrays does: t bit-equal, refs
    equal, with dead lanes."""
    sc, flat = flat_bvhs[name]
    bvh = PB.device_bvh(flat, sc.tris, sc.spheres, "cpu")
    lo, hi = flat.bmin.min(axis=0), flat.bmax.max(axis=0)
    rng = np.random.default_rng(8)
    o = rng.uniform(lo, hi, (512, 3)).astype(np.float32)
    d = rng.normal(0, 1, (512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full(512, FLOAT_MAX, np.float32)
    t_max[::4] = 0.0
    o, d, t_max = map(torch.from_numpy, (o, d, t_max))
    t_r, ref_r = _row_walk(bvh, o, d, t_max, any_hit)
    t_p, ref_p = PB.bvh_traverse(bvh, o, d, t_max, any_hit=any_hit)
    assert int((ref_p >= 0).sum()) > 50
    assert torch.equal(t_r.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(ref_r, ref_p)


def test_wrappers_check_the_node_rows():
    _, ps = both_scenes(3, 50, 5)
    bvh, _ = intersectors(ps)
    o, d, t_max = map(torch.from_numpy, random_rays(16, 3))
    with pytest.raises(ValueError, match="node rows"):
        BK.bvh_closest(bvh._replace(nodes=bvh.nodes[:, :6]), o, d, t_max)
    with pytest.raises(TypeError, match="node rows"):
        BK.bvh_any(bvh._replace(nodes=bvh.nodes.double()), o, d, t_max)
