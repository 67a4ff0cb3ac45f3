"""The port's Halton sampler (curry_pbrt_tpu_torch/ops/halton.py) against
tests/test_halton.py, test for test (the 42-dim parity with the JAX package
is tests/test_torch_sampling.py).

The port holds every uint32 index and digit in int64 tensors; the inputs
here are made as uint32 numpy values and widened, and integer results are
compared as unsigned 32-bit values. Sample values carry the JAX test's
tolerances against the scalar oracle, and are bit-equal to the JAX
package's on the same indices.
"""

import numpy as np
import jax.numpy as jnp
import torch

from curry_pbrt_tpu.ops import halton as JH
from curry_pbrt_tpu_torch.ops import halton as h


def scalar_radical_inverse(x, base):
    """Straight-from-the-math scalar oracle."""
    r, inv = 0.0, 1.0 / base
    w = inv
    while x:
        r += (x % base) * w
        x //= base
        w *= inv
    return r


def scalar_scrambled(x, dim, perms):
    base = h.PRIMES[dim]
    a, c = int(perms[dim, 0]), int(perms[dim, 1])

    def perm(d):
        return (a * d + c) % base

    r, w = 0.0, 1.0 / base
    dc = 0
    while x:
        r += perm(x % base) * w
        x //= base
        w *= 1.0 / base
        dc += 1
    inv = 1.0 / base
    return r + base ** (-dc) * inv * perm(0) / (1 - inv)


def u32(values) -> torch.Tensor:
    """uint32 values → the port's int64 index tensor."""
    return torch.from_numpy(np.asarray(values, np.uint32).astype(np.int64))


class TestRadicalInverse:
    def test_base2_first_values(self):
        vals = h.radical_inverse(u32(range(8)), 2).numpy()
        np.testing.assert_allclose(vals, [0, 0.5, 0.25, 0.75, 0.125, 0.625, 0.375, 0.875],
                                   atol=1e-7)

    def test_matches_scalar_oracle(self):
        rng = np.random.RandomState(0)
        xs = rng.randint(0, 2**32, size=256, dtype=np.uint64).astype(np.uint32)
        for base in (2, 3, 5, 13):
            got = h.radical_inverse(u32(xs), base).numpy()
            want = np.array([scalar_radical_inverse(int(x), base) for x in xs], np.float32)
            np.testing.assert_allclose(got, want, atol=2e-6)
            np.testing.assert_array_equal(got, np.asarray(JH.radical_inverse(jnp.asarray(xs), base)))

    def test_scrambled_matches_scalar(self):
        perms = h.make_permutations(seed=42)
        np.testing.assert_array_equal(perms, JH.make_permutations(seed=42))
        rng = np.random.RandomState(1)
        xs = rng.randint(0, 2**31, size=128).astype(np.uint32)
        for dim in (2, 3, 10, 40, 67, 200, 999):
            got = h.scrambled_radical_inverse(u32(xs), dim, perms).numpy()
            want = np.array([scalar_scrambled(int(x), dim, perms) for x in xs], np.float32)
            np.testing.assert_allclose(got, want, atol=3e-6)
            np.testing.assert_array_equal(
                got, np.asarray(JH.scrambled_radical_inverse(jnp.asarray(xs), dim, perms)))


class TestPixelMapping:
    def test_pixel_reconstruction(self):
        """The reference's own unit test (halton.rs:232-249): the index for
        a pixel must radical-inverse back to that pixel."""
        cfg = h.make_halton_config((9, 4), spp=16)
        offs = h.compute_pixel_offsets(cfg)
        np.testing.assert_array_equal(offs, JH.compute_pixel_offsets(JH.make_halton_config((9, 4), 16)))
        for (px, py) in [(3, 3), (5, 3), (4, 3), (8, 0), (0, 0), (8, 3)]:
            idx = int(offs[py, px])
            assert int(scalar_radical_inverse(idx, 2) * cfg.scale_x) == px
            assert int(scalar_radical_inverse(idx, 3) * cfg.scale_y) == py

    def test_pixel_reconstruction_large(self):
        cfg = h.make_halton_config((640, 480), spp=1)
        offs = h.compute_pixel_offsets(cfg)
        rng = np.random.RandomState(2)
        for _ in range(20):
            px, py = rng.randint(0, 640), rng.randint(0, 480)
            idx = int(offs[py, px])
            assert int(scalar_radical_inverse(idx, 2) * cfg.scale_x) == px
            assert int(scalar_radical_inverse(idx, 3) * cfg.scale_y) == py

    def test_sample_stride_stays_in_pixel(self):
        cfg = h.make_halton_config((64, 64), spp=8)
        offs = h.compute_pixel_offsets(cfg)
        idx0 = u32([offs[10, 20]])
        for k in range(8):
            idx = h.halton_indices(idx0, torch.tensor([k]), cfg)
            assert 0 <= int(idx[0]) < 2**32
            x = scalar_radical_inverse(int(idx[0]), 2) * cfg.scale_x
            y = scalar_radical_inverse(int(idx[0]), 3) * cfg.scale_y
            assert int(x) == 20 and int(y) == 10


class TestSamples:
    def test_dim01_in_unit_interval_and_stratified(self):
        cfg = h.make_halton_config((32, 32), spp=16)
        offs = h.compute_pixel_offsets(cfg)
        perms = h.make_permutations(cfg.seed)
        idx = h.halton_indices(u32(np.full(16, offs[5, 7])), torch.arange(16), cfg)
        u0 = h.halton_sample(idx, 0, cfg, perms).numpy()
        u1 = h.halton_sample(idx, 1, cfg, perms).numpy()
        assert np.all((u0 >= 0) & (u0 < 1)) and np.all((u1 >= 0) & (u1 < 1))
        # 16 base-2 samples in a pixel stratify into distinct 16ths
        assert len(set((u0 * 16).astype(int))) == 16

    def test_all_dims_in_range(self):
        cfg = h.make_halton_config((16, 16), spp=4)
        perms = h.make_permutations(cfg.seed)
        idx = u32(np.arange(0, 4096, 7))
        for dim in (0, 1, 2, 20, 64):
            u = h.halton_sample(idx, dim, cfg, perms).numpy()
            assert np.all((u >= 0) & (u < 1)), dim

    def test_scrambled_uniformity(self):
        cfg = h.make_halton_config((16, 16), spp=4)
        perms = h.make_permutations(cfg.seed)
        idx = u32(np.arange(4096))
        for dim in (2, 3, 7, 35, 67, 500):
            u = h.halton_sample(idx, dim, cfg, perms).numpy()
            hist, _ = np.histogram(u, bins=16, range=(0, 1))
            assert hist.min() > 4096 / 16 * 0.7, (dim, hist)

    def test_prime_table_depth_covers_reference(self):
        assert h.MAX_DIMS == 1000  # halton.rs:141-203 (1000 primes)
        assert h.PRIMES[:8] == [2, 3, 5, 7, 11, 13, 17, 19]
        assert h.PRIMES[999] == 7919
        assert list(h.PRIMES) == list(JH.PRIMES)

    def test_affine_perm_is_bijection(self):
        perms = h.make_permutations(seed=3)
        for dim in (1, 5, 63, 999):
            p = h.PRIMES[dim]
            a, c = int(perms[dim, 0]), int(perms[dim, 1])
            assert {(a * d + c) % p for d in range(p)} == set(range(p))
            # the port's int64 digit permutation, over every digit of the base
            digits = torch.arange(p, dtype=torch.int64)
            mapped = ((digits * a + c) % p).numpy().astype(np.uint32)
            assert sorted(mapped.tolist()) == list(range(p))

    def test_deterministic_across_calls(self):
        cfg = h.make_halton_config((8, 8), spp=2, seed=9)
        perms = h.make_permutations(cfg.seed)
        idx = u32(np.arange(100))
        a = h.halton_sample(idx, 5, cfg, perms).numpy()
        b = h.halton_sample(idx, 5, cfg, perms).numpy()
        np.testing.assert_array_equal(a, b)
