"""The port's vector and sampling math (curry_pbrt_tpu_torch/ops/math.py)
against tests/test_math.py, test for test, on the same seeded numpy inputs.

Each test asserts the JAX test's property on the port's function. Where a
function returns values, they are also held against the JAX package's on
the same inputs, within the JAX test's own tolerance for that property
(1e-5 for unit-length and pdf checks, 1e-4 for round trips): XLA's CPU
lowering contracts a*b+c into FMAs and the two libraries' sin / cos /
atan2 / sqrt may round differently by a few ULPs. Integer results
(sample_usize_remap's index) are exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from curry_pbrt_tpu.ops import math as jm
from curry_pbrt_tpu_torch.ops import math as m


def rand(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def T(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def close_to_jax(port, jax_value, atol):
    np.testing.assert_allclose(port.numpy(), np.asarray(jax_value), rtol=0, atol=atol)


class TestVectors:
    def test_normalize(self):
        v = rand(10, 3) - 0.5
        n = m.normalize(T(v))
        np.testing.assert_allclose(np.linalg.norm(n.numpy(), axis=-1), 1.0, atol=1e-5)
        close_to_jax(n, jm.normalize(jnp.asarray(v)), 1e-6)

    def test_coordinate_system_orthonormal(self):
        z = m.normalize(T(rand(64, 3) - 0.5))
        x, y = m.coordinate_system(z)
        x, y, z = x.numpy(), y.numpy(), z.numpy()
        np.testing.assert_allclose(np.sum(x * z, -1), 0.0, atol=1e-5)
        np.testing.assert_allclose(np.sum(x * y, -1), 0.0, atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(x, axis=-1), 1.0, atol=1e-4)
        np.testing.assert_allclose(np.linalg.norm(y, axis=-1), 1.0, atol=1e-4)
        jx, jy = jm.coordinate_system(jnp.asarray(z))
        np.testing.assert_allclose(x, np.asarray(jx), atol=1e-5)
        np.testing.assert_allclose(y, np.asarray(jy), atol=1e-5)

    def test_local_world_roundtrip(self):
        z = m.normalize(T(rand(32, 3, seed=1) - 0.5))
        x, y = m.coordinate_system(z)
        w = m.normalize(T(rand(32, 3, seed=2) - 0.5))
        local = m.to_local(w, x, y, z)
        back = m.to_world(local, x, y, z)
        np.testing.assert_allclose(back.numpy(), w.numpy(), atol=1e-4)


class TestSampling:
    def test_concentric_disk_in_unit_disk(self):
        u = rand(4096, 2)
        p = m.concentric_sample_disk(T(u)).numpy()
        assert np.all(np.linalg.norm(p, axis=-1) <= 1.0 + 1e-6)
        counts = [
            np.sum((p[:, 0] > 0) & (p[:, 1] > 0)),
            np.sum((p[:, 0] < 0) & (p[:, 1] > 0)),
            np.sum((p[:, 0] < 0) & (p[:, 1] < 0)),
            np.sum((p[:, 0] > 0) & (p[:, 1] < 0)),
        ]
        assert max(counts) - min(counts) < 4096 * 0.08
        close_to_jax(T(p), jm.concentric_sample_disk(jnp.asarray(u)), 1e-6)

    def test_concentric_disk_degenerate(self):
        p = m.concentric_sample_disk(T([[0.5, 0.5], [0.5, 0.25]])).numpy()
        np.testing.assert_allclose(p[0], [0.0, 0.0], atol=1e-7)

    def test_cosine_hemisphere_pdf(self):
        u = rand(512, 2, seed=3)
        w, pdf = m.cosine_sample_hemisphere(T(u))
        w, pdf = w.numpy(), pdf.numpy()
        np.testing.assert_allclose(pdf, w[:, 2] / np.pi, atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(w, axis=-1), 1.0, atol=1e-5)
        assert abs(np.mean(w[:, 2]) - 2.0 / 3.0) < 0.03
        jw, jpdf = jm.cosine_sample_hemisphere(jnp.asarray(u))
        np.testing.assert_allclose(w, np.asarray(jw), atol=1e-5)
        np.testing.assert_allclose(pdf, np.asarray(jpdf), atol=1e-5)

    def test_uniform_sphere_mean_z(self):
        # the reference's "hemisphere" sampler actually covers the sphere
        u = rand(8192, 2, seed=4)
        w = m.uniform_sample_hemisphere(T(u)).numpy()
        assert abs(np.mean(w[:, 2])) < 0.05
        assert w[:, 2].min() < -0.9 and w[:, 2].max() > 0.9
        close_to_jax(T(w), jm.uniform_sample_hemisphere(jnp.asarray(u)), 1e-5)

    def test_uniform_triangle_barycentric(self):
        u = rand(1024, 2, seed=5)
        b = m.uniform_sample_triangle(T(u)).numpy()
        assert np.all(b >= 0) and np.all(b.sum(-1) <= 1.0 + 1e-6)
        close_to_jax(T(b), jm.uniform_sample_triangle(jnp.asarray(u)), 1e-6)

    def test_sample_usize_remap(self):
        u = [0.0, 0.49, 0.99]
        idx, remap = m.sample_usize_remap(T(u), 4)
        np.testing.assert_array_equal(idx.numpy(), [0, 1, 3])
        assert np.all((remap.numpy() >= 0) & (remap.numpy() < 1))
        jidx, jremap = jm.sample_usize_remap(jnp.asarray(u, jnp.float32), 4)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(remap.numpy(), np.asarray(jremap))


class TestRefraction:
    def test_snell(self):
        n = T([[0.0, 0.0, 1.0]])
        wo = m.normalize(T([[0.3, 0.0, 0.8]]))
        wi, ok = m.refract(wo, n, T([1.0 / 1.5]))
        assert bool(ok[0])
        wi, wo_ = wi.numpy()[0], wo.numpy()[0]
        sin_i = np.linalg.norm(wo_[:2])
        sin_t = np.linalg.norm(wi[:2] / np.linalg.norm(wi))
        np.testing.assert_allclose(sin_t, sin_i / 1.5, atol=1e-5)
        assert wi[2] < 0  # transmitted to other side

    def test_total_internal_reflection(self):
        n = T([[0.0, 0.0, 1.0]])
        wo = m.normalize(T([[0.9, 0.0, 0.2]]))
        _, ok = m.refract(wo, n, T([1.5]))
        assert not bool(ok[0])


class TestMisc:
    def test_power_heuristic(self):
        assert float(m.power_heuristic(torch.tensor(1.0), torch.tensor(1.0))) == pytest.approx(0.5)
        assert float(m.power_heuristic(torch.tensor(2.0), torch.tensor(0.0))) == pytest.approx(1.0)

    def test_spherical_roundtrip(self):
        w = m.normalize(T(rand(128, 3, seed=7) - 0.5))
        uv = m.spherical_to_normalized_phi_theta(w)
        back = m.normalized_phi_theta_to_spherical(uv).numpy()
        np.testing.assert_allclose(back, w.numpy(), atol=1e-4)
        close_to_jax(uv, jm.spherical_to_normalized_phi_theta(jnp.asarray(w.numpy())), 1e-5)

    def test_gamma_correct_roundtrip(self):
        f = torch.linspace(0.0, 1.0, 64)
        g = m.gamma_correct(f)
        assert float(g[0]) == 0.0
        assert np.all(np.diff(g.numpy()) > 0)
        close_to_jax(g, jm.gamma_correct(jnp.linspace(0.0, 1.0, 64)), 1e-6)
