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
