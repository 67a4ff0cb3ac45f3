"""Sampling and camera of the PyTorch port against the JAX package.

Integer paths must match exactly: Halton indices, the uint32 hash, pixel
offsets and permutations. The sample values are bit-equal too: both
packages accumulate the same digits in the same f32 order, and the scrambled
tail's pow(base, -digit_count) rounds alike (0 ULP over every dim of the
headline path, measured). Camera directions go through 3- and 4-term dot
products that XLA's CPU lowering fuses into FMAs, differently on different
hosts: each package is held against a float64 evaluation of the camera
formula, and the two against each other by the sum of those bounds;
origins are bit-equal.
"""

from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from curry_pbrt_tpu.ops import halton as JH
from curry_pbrt_tpu.models.camera import generate_rays as jax_generate_rays
from curry_pbrt_tpu.sceneio.compiler import compile_scene_file as jax_compile
from curry_pbrt_tpu_torch.models.camera import generate_rays
from curry_pbrt_tpu_torch.models.integrators import DIMS_PER_BOUNCE
from curry_pbrt_tpu_torch.ops import halton as TH
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file

SCENE = Path(__file__).resolve().parents[1] / "scenes" / "cornell_tex.pbrt"
# the headline config: 512², 64 spp, depth 5 — every dim its path uses
CFG_ARGS = ((512, 512), 64, 0)
N_DIMS = 2 + DIMS_PER_BOUNCE * 5


@pytest.fixture(scope="module")
def indices():
    """Halton indices of 4096 random (pixel, sample) pairs of the headline
    config, from both packages — they must be identical."""
    jcfg = JH.make_halton_config(*CFG_ARGS)
    tcfg = TH.make_halton_config(*CFG_ARGS)
    assert tuple(jcfg) == tuple(tcfg)
    joffs = JH.compute_pixel_offsets(jcfg)[:512, :512]
    toffs = TH.compute_pixel_offsets(tcfg)[:512, :512]
    np.testing.assert_array_equal(joffs, toffs)
    rng = np.random.default_rng(0)
    pix = rng.integers(0, 512 * 512, 4096)
    samp = rng.integers(0, 64, 4096)
    po = joffs.reshape(-1)[pix]
    ji = np.asarray(JH.halton_indices(jnp.asarray(po), jnp.asarray(samp.astype(np.uint32)), jcfg))
    ti = TH.halton_indices(torch.from_numpy(po.astype(np.int64)), torch.from_numpy(samp), tcfg)
    np.testing.assert_array_equal(ji.astype(np.int64), ti.numpy())
    return jcfg, tcfg, ji, ti


def test_permutations_identical():
    np.testing.assert_array_equal(JH.make_permutations(0), TH.make_permutations(0))
    np.testing.assert_array_equal(JH.make_permutations(5), TH.make_permutations(5))


def test_halton_dims_of_the_headline(indices):
    jcfg, tcfg, ji, ti = indices
    perms = JH.make_permutations(0)
    for dim in range(N_DIMS):
        j = np.asarray(JH.halton_sample(jnp.asarray(ji), dim, jcfg, perms))
        t = TH.halton_sample(ti, dim, tcfg, perms).numpy()
        np.testing.assert_array_equal(j, t, err_msg=f"dim {dim}")
        assert np.all((t >= 0) & (t < 1))


def test_digit_loops_bit_equal(indices):
    """The unscrambled digit loop (bases 2, 3, 5, 7, 11) is bit-equal for
    every index, including the truncated trip counts of max_index."""
    jcfg, tcfg, ji, ti = indices
    for base in (2, 3, 5, 7, 11):
        j = np.asarray(JH.radical_inverse(jnp.asarray(ji), base, max_index=jcfg.max_index))
        t = TH.radical_inverse(ti, base, max_index=tcfg.max_index).numpy()
        np.testing.assert_array_equal(j, t, err_msg=f"base {base}")


def test_hash_dims_past_the_prime_table(indices):
    jcfg, tcfg, ji, ti = indices
    perms = JH.make_permutations(0)
    big = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)
    for salt in (0, 0x9E3779B9, 0xFFFFFFFF):
        j = np.asarray(JH._hash_u32(jnp.asarray(big), salt)).astype(np.int64)
        t = TH._hash_u32(torch.from_numpy(big.astype(np.int64)), salt).numpy()
        np.testing.assert_array_equal(j, t)
    for dim in (1000, 1001, 1500):
        j = np.asarray(JH.halton_sample(jnp.asarray(ji), dim, jcfg, perms))
        t = TH.halton_sample(ti, dim, tcfg, perms).numpy()
        np.testing.assert_array_equal(j, t)


# Camera-direction error bounds, in units of 2^-23 (one float32 ULP at 1.0,
# a unit direction's length) against a float64 evaluation of the same
# formula. Per-component ULPs do not bound them: where the raster→camera sum
# cancels, a direction component of 1.5e-6 lies 101,083 of its own ULPs
# from the float64 value in both packages. Measured: the port 1.09, the JAX
# CPU reference 1.04 (4,096 film points of cornell_tex at 512²).
PORT_DIR_ULPS = 2
JAX_DIR_ULPS = 2


def _dir_ulps(d, ref):
    """|d - ref| per component in units of 2^-23."""
    return np.abs(np.asarray(d, np.float64) - ref) / 2.0**-23


def _camera_dirs64(cam, xy):
    """The camera formula in float64 on the float32 operands: (x, y, 0, 1)
    through raster→camera, the divide by w, normalize, camera→world."""
    r2c = np.asarray(cam.raster_to_camera, np.float64)
    c2w = np.asarray(cam.camera_to_world, np.float64)
    x = np.asarray(xy, np.float64)
    ph = np.concatenate([x, np.zeros((len(x), 1)), np.ones((len(x), 1))], axis=-1)
    pc = ph @ r2c.T
    pc = pc[:, :3] / pc[:, 3:4]
    d = pc / np.linalg.norm(pc, axis=-1, keepdims=True)
    return d @ c2w[:3, :3].T


def test_camera_rays():
    """Camera rays of cornell_tex for jittered film points. Origins are
    bit-equal. Directions: the port's and the JAX package's are each held
    against a float64 evaluation of the same formula (PORT_DIR_ULPS,
    JAX_DIR_ULPS), and each other by the sum of the two bounds — the port
    rounds every op separately, while XLA's CPU lowering fuses the 4-wide
    projective product into FMAs in a way that depends on the host (port vs
    JAX measured 3 component ULPs on one host, 2 on another); the
    distance between them cannot exceed their two distances from the
    float64 value."""
    ov = {"resolution": (512, 512), "spp": 64, "max_depth": 5}
    jcam = jax_compile(SCENE, overrides=ov).camera
    tcam = compile_scene_file(SCENE, overrides=ov).camera
    np.testing.assert_array_equal(tcam.raster_to_camera, jcam.raster_to_camera)
    np.testing.assert_array_equal(tcam.camera_to_world, jcam.camera_to_world)
    xy = np.random.default_rng(1).uniform(-0.5, 512.5, (4096, 2)).astype(np.float32)
    jo, jd = map(np.asarray, jax_generate_rays(jcam, jnp.asarray(xy)))
    to, td = generate_rays(tcam, torch.from_numpy(xy))
    np.testing.assert_array_equal(to.numpy(), jo)
    ref = _camera_dirs64(tcam, xy)
    assert _dir_ulps(td.numpy(), ref).max() <= PORT_DIR_ULPS
    assert _dir_ulps(jd, ref).max() <= JAX_DIR_ULPS
    assert _dir_ulps(td.numpy(), jd).max() <= PORT_DIR_ULPS + JAX_DIR_ULPS
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(td.numpy(), axis=-1), 1.0, atol=1e-6)


def test_distribution_samplers():
    """1-D/2-D piecewise-constant tables: identical numpy tables, and the
    torch samplers return the JAX samplers' indices and densities exactly
    and positions within 1 ULP-scale (the remap divides by a pdf)."""
    from curry_pbrt_tpu.ops import distribution as JD
    from curry_pbrt_tpu_torch.ops import distribution as TD

    rng = np.random.default_rng(4)
    f1 = rng.uniform(0, 1, 37) * (rng.uniform(size=37) > 0.2)
    f2 = rng.uniform(0, 1, (9, 13)) * (rng.uniform(size=(9, 13)) > 0.2)
    j1, t1 = JD.build_distribution_1d(f1), TD.build_distribution_1d(f1)
    j2, t2 = JD.build_distribution_2d(f2), TD.build_distribution_2d(f2)
    for a, b in zip(j1, t1):
        np.testing.assert_array_equal(np.asarray(a), b)
    for a, b in zip(j2, t2):
        np.testing.assert_array_equal(np.asarray(a), b)
    u = rng.uniform(0, 1, (512, 2)).astype(np.float32)
    ji, jpdf, jx = JD.sample_1d_continuous(j1, jnp.asarray(u[:, 0]))
    ti, tpdf, tx = TD.sample_1d_continuous(t1, torch.from_numpy(u[:, 0]))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jpdf), tpdf.numpy())
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        np.asarray(JD.pdf_1d_continuous(j1, jnp.asarray(u[:, 1]))),
        TD.pdf_1d_continuous(t1, torch.from_numpy(u[:, 1])).numpy())
    jxy, jd = JD.sample_2d_continuous(j2, jnp.asarray(u))
    txy, td = TD.sample_2d_continuous(t2, torch.from_numpy(u))
    np.testing.assert_allclose(txy.numpy(), np.asarray(jxy), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    np.testing.assert_allclose(TD.pdf_2d_continuous(t2, torch.from_numpy(u)).numpy(),
                               np.asarray(JD.pdf_2d_continuous(j2, jnp.asarray(u))), rtol=1e-6)
