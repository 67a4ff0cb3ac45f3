"""The port's primitive-level intersection (curry_pbrt_tpu_torch/ops/
intersect.py: the dense brute trio, hit attributes, error-offset spawning)
against tests/test_intersect.py, test for test.

Each test asserts the JAX test's property on the port, with its
tolerances. The same rays also go through the JAX package's
intersect_brute: hit masks and prim ids must be equal, and t within the
JAX test's 1e-5.
"""

import numpy as np
import jax.numpy as jnp
import torch

from curry_pbrt_tpu.ops import intersect as JI
from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX
from curry_pbrt_tpu_torch.ops import intersect as isect
from curry_pbrt_tpu_torch.ops import transform as tf

UNIT_TRI = [[0, 0, 0], [1, 0, 0], [0, 1, 0]]


def make_tris(verts, prim_ids=None):
    verts = np.asarray(verts, np.float32).reshape(-1, 3, 3)
    prim = np.arange(len(verts), dtype=np.int32) if prim_ids is None else np.asarray(prim_ids, np.int32)
    return verts[:, 0], verts[:, 1], verts[:, 2], prim


def make_spheres(centers, radii, prim_ids=None):
    centers = np.asarray(centers, np.float32).reshape(-1, 3)
    o2w = np.stack([tf.translate(c) for c in centers]).astype(np.float32)
    w2o = np.stack([tf.translate(-c) for c in centers]).astype(np.float32)
    prim = np.arange(len(centers), dtype=np.int32) if prim_ids is None else np.asarray(prim_ids, np.int32)
    return o2w, w2o, np.asarray(radii, np.float32), prim


NO_TRIS = make_tris(np.zeros((0, 9)))
NO_SPHERES = (np.zeros((0, 4, 4), np.float32), np.zeros((0, 4, 4), np.float32),
              np.zeros((0,), np.float32), np.zeros((0,), np.int32))


def rays(os_, ds_, t_max=None):
    o = np.asarray(os_, np.float32).reshape(-1, 3)
    d = np.asarray(ds_, np.float32).reshape(-1, 3)
    t = np.full((o.shape[0],), FLOAT_MAX, np.float32) if t_max is None else np.asarray(t_max, np.float32)
    return o, d, t


def brute(ray, tris=NO_TRIS, sph=NO_SPHERES):
    """The port's intersect_brute, held against the JAX package's on the
    same inputs (masks and prims equal, t within 1e-5)."""
    th = [torch.from_numpy(np.ascontiguousarray(a)) for a in ray]
    hit = isect.intersect_brute(*th, isect.TriangleArrays(*map(torch.from_numpy, tris)),
                                isect.SphereArrays(*map(torch.from_numpy, sph)))
    jt = JI.TriangleArrays(*map(jnp.asarray, tris)) if len(tris[3]) else JI.empty_triangles()
    js = JI.SphereArrays(*map(jnp.asarray, sph)) if len(sph[3]) else JI.empty_spheres()
    jhit = JI.intersect_brute(*map(jnp.asarray, ray), jt, js)
    np.testing.assert_array_equal(hit.prim.numpy(), np.asarray(jhit.prim))
    valid = hit.valid.numpy()
    np.testing.assert_allclose(hit.t.numpy()[valid], np.asarray(jhit.t)[valid], rtol=0, atol=1e-5)
    return hit


class TestSphere:
    def test_hit_front(self):
        hit = brute(rays([[0, 0, -5]], [[0, 0, 1]]), sph=make_spheres([[0, 0, 0]], [1.0]))
        assert bool(hit.valid[0])
        assert abs(float(hit.t[0]) - 4.0) < 1e-5
        np.testing.assert_allclose(hit.p[0].numpy(), [0, 0, -1], atol=1e-5)
        np.testing.assert_allclose(hit.n[0].numpy(), [0, 0, -1], atol=1e-5)

    def test_inside_hits_far_side(self):
        hit = brute(rays([[0, 0, 0]], [[0, 0, 1]]), sph=make_spheres([[0, 0, 0]], [1.0]))
        assert bool(hit.valid[0]) and abs(float(hit.t[0]) - 1.0) < 1e-5

    def test_miss(self):
        hit = brute(rays([[0, 2, -5]], [[0, 0, 1]]), sph=make_spheres([[0, 0, 0]], [1.0]))
        assert not bool(hit.valid[0])

    def test_t_max_respected(self):
        hit = brute(rays([[0, 0, -5]], [[0, 0, 1]], [3.0]), sph=make_spheres([[0, 0, 0]], [1.0]))
        assert not bool(hit.valid[0])

    def test_translated_sphere_normal(self):
        hit = brute(rays([[10, 0, -9]], [[0, 0, 1]]), sph=make_spheres([[10, 0, 0]], [2.0]))
        assert bool(hit.valid[0])
        np.testing.assert_allclose(hit.p[0].numpy(), [10, 0, -2], atol=1e-4)
        np.testing.assert_allclose(hit.n[0].numpy(), [0, 0, -1], atol=1e-5)

    def test_uv_poles(self):
        hit = brute(rays([[0, 0, 5]], [[0, 0, -1]]), sph=make_spheres([[0, 0, 0]], [1.0]))
        # +z pole → v = acos(1)/π = 0
        assert abs(float(hit.uv[0, 1])) < 1e-5

    def test_grazing_stability(self):
        # rays nearly tangent to a big far sphere: the stable quadratic must
        # not produce spurious misses or NaNs
        ys = np.linspace(99.99, 100.01, 64, dtype=np.float32)
        o = np.stack([np.zeros(64), ys, np.full(64, -100.0)], -1).astype(np.float32)
        d = np.tile(np.asarray([[0, 0, 1]], np.float32), (64, 1))
        hit = brute(rays(o, d), sph=make_spheres([[0, 0, 1000]], [100.0]))
        assert not np.any(np.isnan(hit.t.numpy()))
        assert np.all(hit.valid.numpy()[ys < 99.995])


class TestTriangle:
    def test_hit_and_barycentric(self):
        hit = brute(rays([[0.25, 0.25, -3]], [[0, 0, 1]]), make_tris([UNIT_TRI]))
        assert bool(hit.valid[0])
        assert abs(float(hit.t[0]) - 3.0) < 1e-5
        np.testing.assert_allclose(hit.p[0].numpy(), [0.25, 0.25, 0], atol=1e-5)

    def test_edge_is_watertight(self):
        # two triangles sharing a diagonal: rays through the shared edge must
        # hit exactly one of them (no leaks)
        quad = [[[0, 0, 0], [1, 0, 0], [1, 1, 0]], [[1, 1, 0], [0, 1, 0], [0, 0, 0]]]
        ts = np.linspace(0.01, 0.99, 97, dtype=np.float32)
        o = np.stack([ts, ts, np.full_like(ts, -1.0)], -1)
        d = np.tile(np.asarray([[0, 0, 1]], np.float32), (97, 1))
        hit = brute(rays(o, d), make_tris(quad))
        assert np.all(hit.valid.numpy())

    def test_miss_outside(self):
        hit = brute(rays([[0.9, 0.9, -3]], [[0, 0, 1]]), make_tris([UNIT_TRI]))
        assert not bool(hit.valid[0])

    def test_backface_still_hits(self):
        hit = brute(rays([[0.25, 0.25, 3]], [[0, 0, -1]]), make_tris([UNIT_TRI]))
        assert bool(hit.valid[0])

    def test_normal_orientation(self):
        hit = brute(rays([[0.25, 0.25, -3]], [[0, 0, 1]]), make_tris([UNIT_TRI]))
        # n = normalize((p0-p2) × (p1-p2)) = +z for CCW in xy
        np.testing.assert_allclose(hit.n[0].numpy(), [0, 0, 1], atol=1e-6)

    def test_padding_ignored(self):
        tris = make_tris([UNIT_TRI, [[0, 0, 0], [0, 0, 0], [0, 0, 0]]], prim_ids=[0, -1])
        hit = brute(rays([[0.25, 0.25, -3]], [[0, 0, 1]]), tris)
        assert bool(hit.valid[0]) and int(hit.prim[0]) == 0

    def test_closest_of_many(self):
        tris = make_tris([
            [[-9, -9, 5], [9, -9, 5], [0, 9, 5]],
            [[-9, -9, 2], [9, -9, 2], [0, 9, 2]],
            [[-9, -9, 8], [9, -9, 8], [0, 9, 8]],
        ])
        hit = brute(rays([[0, 0, 0]], [[0, 0, 1]]), tris)
        assert int(hit.prim[0]) == 1 and abs(float(hit.t[0]) - 2.0) < 1e-5

    def test_mixed_tri_sphere_closest(self):
        tris = make_tris([[[-9, -9, 5], [9, -9, 5], [0, 9, 5]]], prim_ids=[0])
        sph = make_spheres([[0, 0, 3]], [0.5], prim_ids=[1])
        hit = brute(rays([[0, 0, 0]], [[0, 0, 1]]), tris, sph)
        assert int(hit.prim[0]) == 1 and abs(float(hit.t[0]) - 2.5) < 1e-5

    def test_unnormalized_direction(self):
        # shadow rays use d = to - from with t ∈ [0, 1)
        hit = brute(rays([[0.2, 0.2, -4]], [[0, 0, 8]], [1.0 - 1e-5]), make_tris([UNIT_TRI]))
        assert bool(hit.valid[0]) and abs(float(hit.t[0]) - 0.5) < 1e-5


class TestPredicate:
    def test_predicate(self):
        tris = make_tris([UNIT_TRI])
        sph = make_spheres([[5, 0, 0]], [1.0], prim_ids=[1])
        ray = rays([[0.2, 0.2, -1], [5, 0, -9], [9, 9, -1]], [[0, 0, 1], [0, 0, 1], [0, 0, 1]])
        p = isect.intersect_predicate_brute(
            *map(torch.from_numpy, ray), isect.TriangleArrays(*map(torch.from_numpy, tris)),
            isect.SphereArrays(*map(torch.from_numpy, sph)))
        assert p.tolist() == [True, True, False]
        jp = JI.intersect_predicate_brute(*map(jnp.asarray, ray),
                                          JI.TriangleArrays(*map(jnp.asarray, tris)),
                                          JI.SphereArrays(*map(jnp.asarray, sph)))
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))


class TestOffsets:
    def test_spawned_ray_does_not_self_hit(self):
        tris = make_tris([[[-5, -5, 0], [5, -5, 0], [0, 5, 0]]])
        hit = brute(rays([[0.1, 0.1, -3]], [[0, 0, 1]]), tris)
        # bounce straight back toward the camera
        new_d = torch.tensor([[0.0, 0.0, -1.0]])
        no, nd = isect.spawn_ray(hit.p, hit.n, hit.p_error, new_d)
        hit2 = brute((no.numpy(), nd.numpy(), np.full((1,), FLOAT_MAX, np.float32)), tris)
        assert not bool(hit2.valid[0])
