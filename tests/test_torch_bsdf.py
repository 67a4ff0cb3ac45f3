"""The port's non-delta BSDF lobes (curry_pbrt_tpu_torch/ops/bsdf.py:
lambert_r, lambert_t, oren_nayar, ggx_r, ggx_t) against the JAX package's
ops/bsdf.py on the same numpy inputs: f, pdf and presence from lobe_f /
lobe_pdf, the sampled (wi, f, pdf, present) from lobe_sample, and the
BSDF-level eval and non-delta sampler over a plastic-like lobe list.

Presence masks must be equal. Values (of samples, where the lobe kept
them) agree within rtol 2e-4 / atol 2e-5:
the GGX terms go through sqrt, cos, sin and rsqrt, which XLA's CPU lowering
and torch round differently (a few ULPs), and XLA contracts a*b+c into
FMAs; the distribution term D and the VNDF pdf divide by cos⁴θ and so
amplify those ULPs at grazing angles (values reach ~1e3 there, and the
comparison is relative). Sampled values may fall outside that tolerance on
at most 0.2% of lanes: the VNDF sampler's slope inversion (tmp = 1/(A²−1),
microfacet.rs:39-92) is ill-conditioned near normal incidence and turns
ULP differences into up to ~3e-4 in the sampled half vector.

Below those, every test of tests/test_bsdf.py runs on the port with its own
seeds and tolerances (Fresnel limits, furnace integrals, reciprocity, the
delta lobes, the BSDF-level bucket probabilities).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from curry_pbrt_tpu.ops import bsdf as JB
from curry_pbrt_tpu_torch.ops import bsdf as TB

RTOL, ATOL = 2e-4, 2e-5
SAMPLE_OUTLIERS = 0.002
N = 4096


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's tests. torch's float unary
    kernels on the CPU split an op over threads at a 2,048-element grain,
    and in 5 of 69 test processes the first lane sample here
    (torch.cos in concentric_sample_disk, 4,096 lanes) came back with lanes
    2,048-4,095, the second thread's half, off by ~1e-4 relative (median
    8.8e-5; torch.sin and lanes 0-2,047 right, and a later threaded cos in
    that process right): `sampled wi` then fails lambert_r with ~280 values
    outside the tolerance. On one thread every run gives the same values."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    wo, wi = _unit(rng, N), _unit(rng, N)
    wo[:64, 2] = 0.0  # grazing / degenerate lanes
    wi[64:96] = wo[64:96] * np.float32(-1.0)  # wh = 0 for the GGX reflect lobe
    u = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    u[:16, 0] = 0.0
    return wo, wi, u


def _params(rng, kind):
    """Per-lane lobe parameters as numpy, keyed by Lobe field."""
    p = {"albedo": rng.uniform(0.1, 0.9, (N, 3)).astype(np.float32)}
    if kind == "oren_nayar":
        sigma = np.deg2rad(rng.uniform(0, 60, N)).astype(np.float32)
        s2 = sigma * sigma
        p["on_a"] = (1.0 - s2 / (2.0 * (sigma + 0.33))).astype(np.float32)
        p["on_b"] = (0.45 * s2 / (s2 + 0.09)).astype(np.float32)
    if kind in ("ggx_r", "ggx_t"):
        p["alpha_x"] = rng.uniform(0.05, 0.8, N).astype(np.float32)
        p["alpha_y"] = rng.uniform(0.05, 0.8, N).astype(np.float32)
        p["eta_a"] = np.ones(N, np.float32)
        p["eta_b"] = np.full(N, 1.5, np.float32)
    return p


def _lobes(kind, p):
    j = JB.Lobe(kind, **{k: jnp.asarray(v) for k, v in p.items()})
    t = TB.Lobe(kind, **{k: torch.from_numpy(v) for k, v in p.items()})
    return j, t


def _close(port, ref, what, where=None, outliers=0.0):
    """allclose(RTOL, ATOL), with at most a fraction `outliers` of the values
    outside it; `where` keeps the lanes whose sample the lobe kept."""
    port, ref = port.numpy(), np.asarray(ref)
    if where is not None:
        port, ref = port[where.numpy()], ref[where.numpy()]
    assert np.isfinite(port).all() == np.isfinite(ref).all(), what
    if not outliers:
        np.testing.assert_allclose(port, ref, rtol=RTOL, atol=ATOL, err_msg=what)
        return
    outside = ~np.isclose(port, ref, rtol=RTOL, atol=ATOL)
    assert outside.mean() <= outliers, (what, outside.sum(), np.abs(port - ref).max())


@pytest.mark.parametrize("kind", ["lambert_r", "lambert_t", "oren_nayar", "ggx_r", "ggx_t"])
def test_lobe_f_pdf_and_sample_match_jax(kind):
    wo, wi, u = _inputs(1)
    jl, tl = _lobes(kind, _params(np.random.default_rng(2), kind))
    jwo, jwi, ju = map(jnp.asarray, (wo, wi, u))
    two, twi, tu = map(torch.from_numpy, (wo, wi, u))

    jf, jp = JB.lobe_f(jl, jwo, jwi)
    tf, tp = TB.lobe_f(tl, two, twi)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    _close(tf, jf, "f")
    _close(TB.lobe_pdf(tl, two, twi), JB.lobe_pdf(jl, jwo, jwi), "pdf")

    jwi_s, jf_s, jpdf_s, jpres = JB.lobe_sample(jl, jwo, ju)
    twi_s, tf_s, tpdf_s, tpres = TB.lobe_sample(tl, two, tu)
    np.testing.assert_array_equal(tpres.numpy(), np.asarray(jpres))
    assert tpres.sum() > N // 4
    _close(twi_s, jwi_s, "sampled wi", tpres, SAMPLE_OUTLIERS)
    _close(tf_s, jf_s, "sampled f", tpres, SAMPLE_OUTLIERS)
    _close(tpdf_s, jpdf_s, "sampled pdf", None, SAMPLE_OUTLIERS)


def test_bsdf_algebra_over_a_plastic_stack():
    """bsdf_eval_pdf and bsdf_sample_nondelta over [lambert_r, ggx_r] (the
    plastic material) and a translucent-like [lambert_t, ggx_t]."""
    wo, wi, u = _inputs(3)
    rng = np.random.default_rng(4)
    for kinds in (("lambert_r", "ggx_r"), ("lambert_t", "ggx_t", "oren_nayar")):
        pairs = [_lobes(k, _params(rng, k)) for k in kinds]
        jl, tl = [p[0] for p in pairs], [p[1] for p in pairs]
        jf, jp, jpres = JB.bsdf_eval_pdf(jl, jnp.asarray(wo), jnp.asarray(wi))
        tf, tp, tpres = TB.bsdf_eval_pdf(tl, torch.from_numpy(wo), torch.from_numpy(wi))
        np.testing.assert_array_equal(tpres.numpy(), np.asarray(jpres))
        _close(tf, jf, f"{kinds} eval f")
        _close(tp, jp, f"{kinds} eval pdf")
        jo = JB.bsdf_sample_nondelta(jl, jnp.asarray(wo), jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1]))
        to = TB.bsdf_sample_nondelta(tl, torch.from_numpy(wo), torch.from_numpy(u[:, 0]),
                                     torch.from_numpy(u[:, 1]))
        np.testing.assert_array_equal(to[3].numpy(), np.asarray(jo[3]))
        for what, a, b in zip(("wi", "f", "pdf"), to[:3], jo[:3]):
            _close(a, b, f"{kinds} sample {what}", to[3], SAMPLE_OUTLIERS)


# ---------------------------------------------------------------------------
# tests/test_bsdf.py, test for test, on the port: the JAX tests' physical
# properties (Fresnel limits, furnace integrals, reciprocity, delta lobes,
# the BSDF-level bucket probabilities) with their own tolerances and seeds.


def lam(albedo=0.5, n=64):
    return TB.Lobe("lambert_r", torch.full((n, 3), albedo))


def ggx(albedo=1.0, rough=0.3, n=64):
    alpha = TB.roughness_to_alpha(torch.full((n,), rough))
    ones = torch.ones((n,))
    return TB.Lobe("ggx_r", torch.full((n, 3), albedo), alpha_x=alpha, alpha_y=alpha,
                   eta_a=ones, eta_b=1.5 * ones)


def rand_wo(n, seed=0, up=True):
    rng = np.random.RandomState(seed)
    v = rng.randn(n, 3).astype(np.float32)
    v[:, 2] = np.abs(v[:, 2]) if up else v[:, 2]
    return torch.from_numpy(v / np.linalg.norm(v, axis=-1, keepdims=True))


def rand_u(n, seed=1):
    return torch.from_numpy(np.random.RandomState(seed).rand(n, 2).astype(np.float32))


def rand_1d(n, seed):
    return torch.from_numpy(np.random.RandomState(seed).rand(n).astype(np.float32))


def tiled(v, n):
    from curry_pbrt_tpu_torch.ops import math as m

    return m.normalize(torch.tensor([v], dtype=torch.float32)).repeat(n, 1)


class TestFresnel:
    def test_normal_incidence(self):
        # F0 = ((n1-n2)/(n1+n2))² = (0.5/2.5)² = 0.04
        fr = TB.fresnel_dielectric(torch.tensor([1.0]), torch.tensor([1.0]), torch.tensor([1.5]))
        assert abs(float(fr[0]) - 0.04) < 1e-4

    def test_grazing_is_one(self):
        fr = TB.fresnel_dielectric(torch.tensor([1e-4]), torch.tensor([1.0]), torch.tensor([1.5]))
        assert float(fr[0]) > 0.98

    def test_tir(self):
        fr = TB.fresnel_dielectric(torch.tensor([-0.5]), torch.tensor([1.0]), torch.tensor([1.5]))
        assert float(fr[0]) == 1.0

    def test_energy_split(self):
        cos = torch.from_numpy(np.linspace(0.05, 1.0, 32, dtype=np.float32))
        fr = TB.fresnel_dielectric(cos, torch.ones(32), torch.full((32,), 1.5)).numpy()
        assert np.all((fr >= 0) & (fr <= 1))
        jfr = JB.fresnel_dielectric(jnp.asarray(cos.numpy()), jnp.ones(32), jnp.full((32,), 1.5))
        np.testing.assert_allclose(fr, np.asarray(jfr), rtol=RTOL, atol=ATOL)


class TestLambert:
    def test_f_value(self):
        f, pres = TB.lobe_f(lam(0.8, 4), rand_wo(4), rand_wo(4, seed=2))
        np.testing.assert_allclose(f.numpy(), 0.8 / np.pi, atol=1e-6)
        assert bool(pres.all())

    def test_sample_hemisphere_side(self):
        wo = rand_wo(256)
        wi, f, pdf, pres = TB.lobe_sample(lam(0.5, 256), wo, rand_u(256))
        wi = wi.numpy()
        assert np.all(wi[:, 2] * wo.numpy()[:, 2] >= 0)
        np.testing.assert_allclose(pdf.numpy(), np.abs(wi[:, 2]) / np.pi, atol=1e-5)

    def test_white_furnace_integral(self):
        """∫ f |cos| / pdf with cosine sampling = albedo exactly per sample."""
        n = 1024
        wi, f, pdf, pres = TB.lobe_sample(lam(0.7, n), tiled([0.3, 0.1, 0.95], n), rand_u(n, seed=5))
        est = f.numpy()[:, 0] * np.abs(wi.numpy()[:, 2]) / pdf.numpy()
        np.testing.assert_allclose(est, 0.7, atol=1e-4)


class TestGGX:
    def test_sample_eval_consistency(self):
        g = ggx(n=512)
        wo = rand_wo(512, seed=3)
        wi, f, pdf, pres = TB.lobe_sample(g, wo, rand_u(512, seed=4))
        f2, _ = TB.lobe_f(g, wo, wi)
        sel = pres.numpy()
        assert sel.mean() > 0.5
        np.testing.assert_allclose(f.numpy()[sel], f2.numpy()[sel], rtol=1e-3, atol=1e-5)
        assert np.all(pdf.numpy()[sel] > 0)

    def test_reciprocity(self):
        g = ggx(n=128)
        wo, wi = rand_wo(128, seed=6), rand_wo(128, seed=7)
        f1, _ = TB.lobe_f(g, wo, wi)
        f2, _ = TB.lobe_f(g, wi, wo)
        np.testing.assert_allclose(f1.numpy(), f2.numpy(), rtol=1e-3, atol=1e-6)

    def test_furnace_bounded(self):
        """Energy: ∫ f cos ≤ 1 — Monte Carlo with the VNDF sampler."""
        n = 8192
        wi, f, pdf, pres = TB.lobe_sample(ggx(albedo=1.0, rough=0.4, n=n), tiled([0.4, 0.0, 0.9], n),
                                          rand_u(n, seed=8))
        sel = pres.numpy() & (pdf.numpy() > 1e-9)
        est = f.numpy()[sel, 0] * np.abs(wi.numpy()[sel, 2]) / pdf.numpy()[sel]
        total = est.sum() / n
        # dielectric Fresnel at eta 1.5 keeps reflected energy near F0≈0.04
        assert 0.005 < total <= 0.15, total


class TestSpecular:
    def test_mirror_reflection_direction(self):
        n = 8
        wo = rand_wo(n, seed=9)
        wi, f, ok = TB.delta_lobe_sample(TB.Lobe("spec_r", torch.ones((n, 3)), fresnel_noop=True), wo)
        wi, wo_ = wi.numpy(), wo.numpy()
        np.testing.assert_allclose(wi[:, :2], -wo_[:, :2], atol=1e-6)
        np.testing.assert_allclose(wi[:, 2], wo_[:, 2], atol=1e-6)
        # f = 1/|cos| so f·|cos| = 1 (perfect mirror)
        np.testing.assert_allclose(f.numpy()[:, 0] * np.abs(wi[:, 2]), 1.0, atol=1e-5)

    def test_glass_energy_split(self):
        """Fresnel-weighted reflection + transmission ≈ unit energy."""
        n = 64
        ones = torch.ones((n,))
        r = TB.Lobe("spec_r", torch.ones((n, 3)), eta_a=ones, eta_b=1.5 * ones)
        t = TB.Lobe("spec_t", torch.ones((n, 3)), eta_a=ones, eta_b=1.5 * ones)
        wo = rand_wo(n, seed=10)
        wir, fr_, _ = TB.delta_lobe_sample(r, wo)
        wit, ft_, okt = TB.delta_lobe_sample(t, wo)
        er = fr_.numpy()[:, 0] * np.abs(wir.numpy()[:, 2])
        et = ft_.numpy()[:, 0] * np.abs(wit.numpy()[:, 2]) * okt.numpy()
        np.testing.assert_allclose(er + et, 1.0, atol=1e-4)

    def test_refraction_bends(self):
        n = 4
        ones = torch.ones((n,))
        t = TB.Lobe("spec_t", torch.ones((n, 3)), eta_a=ones, eta_b=1.5 * ones)
        wi, f, ok = TB.delta_lobe_sample(t, tiled([0.3, 0.0, 0.954], n))
        assert bool(ok.all())
        wi = wi[0].numpy()
        sin_i = 0.3 / np.sqrt(0.3**2 + 0.954**2)
        sin_t = abs(wi[0]) / np.linalg.norm(wi)
        np.testing.assert_allclose(sin_t, sin_i / 1.5, atol=1e-4)
        assert wi[2] < 0


class TestBSDFAlgebra:
    def test_eval_pdf_reflect_bucket(self):
        n = 32
        wi = rand_wo(n, seed=12)
        f, pdf, pres = TB.bsdf_eval_pdf([lam(0.6, n), lam(0.2, n)], rand_wo(n, seed=11), wi)
        np.testing.assert_allclose(f.numpy()[:, 0], 0.8 / np.pi, atol=1e-5)
        # mean cosine pdf over the 2-lobe reflect bucket = |cos|/π
        np.testing.assert_allclose(pdf.numpy(), np.abs(wi.numpy()[:, 2]) / np.pi, atol=1e-5)

    def test_sample_nondelta_uniform_choice(self):
        n = 4096
        wi, f, pdf, pres = TB.bsdf_sample_nondelta([lam(1.0, n), ggx(n=n)], tiled([0.2, 0.1, 0.97], n),
                                                   rand_1d(n, 13), rand_1d(n, 14))
        assert pres.numpy().mean() > 0.7
        assert np.all(pdf.numpy()[pres.numpy()] > 0)

    def test_sample_delta_luminance_weights(self):
        n = 4096
        bright = TB.Lobe("spec_r", torch.full((n, 3), 0.9), fresnel_noop=True)
        dim = TB.Lobe("spec_r", torch.full((n, 3), 0.1), fresnel_noop=True)
        wi, f, pdf, pres = TB.bsdf_sample_delta([bright, dim], rand_wo(n, seed=15), rand_1d(n, 16))
        pdfs = np.unique(np.round(pdf.numpy(), 4))
        assert len(pdfs) == 2
        # weights ∝ 0.9 : 0.1 regardless of cos factor (shared 1/|cos|)
        np.testing.assert_allclose(sorted(pdfs), [0.1, 0.9], atol=1e-3)
        frac_bright = (np.abs(pdf.numpy() - 0.9) < 1e-3).mean()
        assert abs(frac_bright - 0.9) < 0.03

    def test_sample_f_bucket_probabilities(self):
        """plastic-like: 2 non-delta + 1 delta → non-delta picked 2/3."""
        n = 8192
        lobes = [lam(0.5, n), ggx(n=n), TB.Lobe("spec_r", torch.ones((n, 3)), fresnel_noop=True)]
        out = TB.bsdf_sample(lobes, tiled([0.1, 0.2, 0.97], n), rand_1d(n, 17), rand_1d(n, 18))
        assert abs(out[4].numpy().mean() - 1.0 / 3.0) < 0.02

    def test_oren_nayar_reduces_to_lambert_at_sigma0(self):
        n = 16
        on = TB.Lobe("oren_nayar", torch.full((n, 3), 0.5), on_a=torch.ones((n,)),
                     on_b=torch.zeros((n,)))
        f, _ = TB.lobe_f(on, rand_wo(n, seed=19), rand_wo(n, seed=20))
        np.testing.assert_allclose(f.numpy(), 0.5 / np.pi, atol=1e-6)
