"""The port's kernel-backed aggregate (ops/kernels/aggregate.py) against the
JAX package's make_pallas_intersectors (Pallas kernels in interpret mode on
the CPU), on cornell_tex camera rays and on bounce rays spawned from their
hits in numpy-seeded directions.

Prims and hit masks must be equal. t, p, n and uv agree within rtol 1e-5 /
atol 1e-3 (the scene spans ~560 units, so 1e-3 is ~16 f32 ULPs of its
coordinates): the triangle attributes divide by the watertight determinant,
and XLA's CPU lowering contracts a*b+c into FMAs where the port rounds each
op separately.
"""

from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from curry_pbrt_tpu.ops.pallas.aggregate import make_pallas_intersectors
from curry_pbrt_tpu.sceneio.compiler import compile_scene_file as jax_compile
from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX
from curry_pbrt_tpu_torch.models.camera import generate_rays
from curry_pbrt_tpu_torch.ops.intersect import offset_point_by_error
from curry_pbrt_tpu_torch.ops import intersect as isect
from curry_pbrt_tpu_torch.ops.kernels import aggregate as AG
from curry_pbrt_tpu_torch.ops.kernels.aggregate import make_kernel_intersectors
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file

SCENE = Path(__file__).resolve().parents[1] / "scenes" / "cornell_tex.pbrt"
RTOL, ATOL = 1e-5, 1e-3


@pytest.fixture(scope="module")
def both():
    ov = {"resolution": (64, 64), "spp": 1, "max_depth": 2}
    js, ps = jax_compile(SCENE, overrides=ov), compile_scene_file(SCENE, overrides=ov)
    cam = np.asarray(ps.camera.camera_to_world)[:3, 3]
    jx = make_pallas_intersectors(js.tris, js.spheres, view_origin=cam)
    tx = make_kernel_intersectors(ps.tris, ps.spheres, "cpu", view_origin=cam)
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 64, (1024, 2)).astype(np.float32)
    o, d = generate_rays(ps.camera, torch.from_numpy(xy))
    t_max = torch.full((1024,), float(FLOAT_MAX))
    t_max[::9] = 0.0  # dead lanes
    return jx, tx, o, d, t_max


def _call_both(jx, tx, which, o, d, t_max):
    j = jx[which](*(jnp.asarray(x.numpy()) for x in (o, d, t_max)))
    t = tx[which](o, d, t_max)
    return j, t


def _assert_hits(jh, th):
    jprim, tprim = np.asarray(jh.prim), th.prim.numpy()
    np.testing.assert_array_equal(jprim, tprim)
    hit = tprim >= 0
    assert hit.sum() > 100
    np.testing.assert_allclose(th.t.numpy()[hit], np.asarray(jh.t)[hit], rtol=RTOL, atol=ATOL)
    for f in ("p", "n", "uv", "p_error"):
        np.testing.assert_allclose(getattr(th, f).numpy()[hit], np.asarray(getattr(jh, f))[hit],
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    assert np.all(th.t.numpy()[~hit] == FLOAT_MAX)


def _bounce_rays(th, d, seed):
    """Cosine-free random continuation rays from the camera hits."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1, (d.shape[0], 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    w = torch.from_numpy(w)
    flip = (w * th.n).sum(-1) * (-d * th.n).sum(-1) < 0  # stay on the viewer's side
    w = torch.where(flip[:, None], -w, w)
    o2 = offset_point_by_error(th.p, th.n, th.p_error, w)
    t2 = torch.where(th.prim >= 0, float(FLOAT_MAX), 0.0)
    return o2, w, t2


def test_camera_and_bounce_rays(both):
    jx, tx, o, d, t_max = both
    jh, th = _call_both(jx, tx, 0, o, d, t_max)
    _assert_hits(jh, th)
    o2, d2, t2 = _bounce_rays(th, d, 1)
    jh2, th2 = _call_both(jx, tx, 0, o2, d2, t2)
    _assert_hits(jh2, th2)


def test_predicate_and_tprim(both):
    jx, tx, o, d, t_max = both
    _, th = _call_both(jx, tx, 0, o, d, t_max)
    o2, d2, t2 = _bounce_rays(th, d, 2)
    # shadow rays toward a point on the ceiling lamp, t_max 1 - 1e-5
    lamp = torch.tensor([278.0, 548.0, 279.5])
    sd = lamp - o2
    st = torch.where(th.prim >= 0, 1.0 - 1e-5, 0.0)
    jp, tp = _call_both(jx, tx, 1, o2, sd, st)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    assert 0 < tp.sum() < tp.shape[0]
    (jt, jprim), (tt, tprim) = _call_both(jx, tx, 2, o2, d2, t2)
    np.testing.assert_array_equal(np.asarray(jprim), tprim.numpy())
    hit = tprim.numpy() >= 0
    np.testing.assert_allclose(tt.numpy()[hit], np.asarray(jt)[hit], rtol=RTOL, atol=ATOL)
    # (t, prim) agrees with the full hit record of the same rays
    th2 = tx[0](o2, d2, t2)
    np.testing.assert_array_equal(th2.prim.numpy(), tprim.numpy())
    np.testing.assert_array_equal(th2.t.numpy(), tt.numpy())


def test_geometry_is_detached(both):
    _, tx, o, d, t_max = both
    o = o.clone().requires_grad_(True)
    h = tx[0](o, d, t_max)
    assert not h.t.requires_grad and not h.p.requires_grad


def _jax_sort_key(o, d, t_max, lo3, ext3):
    """The JAX package's "oct_cell" key (ops/pallas/aggregate.py:215-246),
    in numpy uint32."""
    q = np.clip((o - lo3) / ext3 * np.float32(8.0), 0.0, 7.0).astype(np.uint32)

    def spread3(x):
        x = (x | (x << np.uint32(4))) & np.uint32(0x0C3)
        return (x | (x << np.uint32(2))) & np.uint32(0x249)

    cell = (spread3(q[:, 0]) << np.uint32(2)) | (spread3(q[:, 1]) << np.uint32(1)) | spread3(q[:, 2])
    octant = ((d[:, 0] < 0).astype(np.uint32) * 4 + (d[:, 1] < 0).astype(np.uint32) * 2
              + (d[:, 2] < 0).astype(np.uint32))
    return np.where(t_max > 0, octant * np.uint32(512) + cell, np.uint32(1 << 14))


def test_sort_key_matches_jax():
    rng = np.random.default_rng(4)
    o = rng.uniform(-6, 6, (4096, 3)).astype(np.float32)  # many outside the box
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d[::5, 1] = 0.0
    t_max = np.where(rng.uniform(size=4096) < 0.2, 0.0, 1e30).astype(np.float32)
    lo3 = np.array([-2.0, -1.5, -3.0], np.float32)
    ext3 = np.array([4.0, 3.0, 5.5], np.float32)
    key = AG.sort_key(*(torch.from_numpy(a) for a in (o, d, t_max, lo3, ext3)))
    np.testing.assert_array_equal(key.numpy(), _jax_sort_key(o, d, t_max, lo3, ext3))


def test_ray_sort_changes_no_result():
    """Sorted and unsorted traversals (forced on and off, on a mesh that is
    not a small scene) give bit-equal hits, shadow tests and (t, prim)."""
    rng = np.random.default_rng(8)
    n_tris = 2000
    p0 = rng.uniform(-6, 6, (n_tris, 3)).astype(np.float32)
    p1 = p0 + rng.normal(0, 0.5, (n_tris, 3)).astype(np.float32)
    p2 = p0 + rng.normal(0, 0.5, (n_tris, 3)).astype(np.float32)
    tris = isect.TriangleArrays(p0, p1, p2, np.arange(n_tris, dtype=np.int32))
    z = np.zeros((1, 4, 4), np.float32)
    sph = isect.SphereArrays(z, z, np.zeros(1, np.float32), np.full(1, -1, np.int32))
    o = torch.from_numpy(rng.uniform(-7, 7, (1024, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(1024, 3)).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    t_max = torch.full((1024,), float(FLOAT_MAX))
    t_max[::6] = 0.0
    on = make_kernel_intersectors(tris, sph, "cpu", view_origin=np.zeros(3), ray_sort=True)
    off = make_kernel_intersectors(tris, sph, "cpu", view_origin=np.zeros(3), ray_sort=False)
    AG.RAY_SORTS["traversals"] = 0
    h_on, h_off = on[0](o, d, t_max), off[0](o, d, t_max)
    for a, b in zip(h_on, h_off):
        assert torch.equal(a, b)
    assert (h_on.prim >= 0).sum() > 100
    assert torch.equal(on[1](o, d, t_max * 0.5), off[1](o, d, t_max * 0.5))
    for a, b in zip(on[2](o, d, t_max), off[2](o, d, t_max)):
        assert torch.equal(a, b)
    assert AG.RAY_SORTS["traversals"] == 3  # closest, shadow, (t, prim): each sorted once
