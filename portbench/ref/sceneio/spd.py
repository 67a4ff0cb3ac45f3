"""Sampled-SPD → RGB conversion (scene-compile time only).

The reference resamples an input SPD onto 471 CIE wavelengths (360–830 nm),
integrates against tabulated CIE X/Y/Z matching curves, and converts XYZ→RGB
(reference src/spectrum/rgb_spectrum.rs:85-96,211-237). We use the
analytic multi-lobe Gaussian fits of the CIE 1931 standard observer
(Wyman, Sloan & Shirley, "Simple Analytic Approximations to the CIE XYZ
Color Matching Functions", JCGT 2013) instead of shipping the table — the
fits agree with the table to well under 1% of peak, far below Monte-Carlo
noise. The conversion happens entirely host-side in numpy; kernels only ever
see RGB.

Note: the reference's `lerp` has its endpoints swapped (math/mod.rs:8-14),
which biases its SPD resampling by up to one inter-sample step; we
interpolate correctly (documented divergence, DESIGN.md).
"""

from __future__ import annotations

import numpy as np

LAMBDA_START = 360.0
LAMBDA_END = 831.0
N_SAMPLES = 471  # 1 nm spacing, matching the reference grid


def _g(x, mu, s1, s2):
    """Piecewise Gaussian: sigma s1 below mu, s2 above."""
    s = np.where(x < mu, s1, s2)
    t = (x - mu) / s
    return np.exp(-0.5 * t * t)


def cie_x(lam):
    return (
        1.056 * _g(lam, 599.8, 37.9, 31.0)
        + 0.362 * _g(lam, 442.0, 16.0, 26.7)
        - 0.065 * _g(lam, 501.1, 20.4, 26.2)
    )


def cie_y(lam):
    return 0.821 * _g(lam, 568.8, 46.9, 40.5) + 0.286 * _g(lam, 530.9, 16.3, 31.1)


def cie_z(lam):
    return 1.217 * _g(lam, 437.0, 11.8, 36.0) + 0.681 * _g(lam, 459.0, 26.0, 13.8)


_LAMBDAS = np.arange(LAMBDA_START, LAMBDA_END, dtype=np.float64)
_CIE_XYZ = np.stack([cie_x(_LAMBDAS), cie_y(_LAMBDAS), cie_z(_LAMBDAS)], axis=0)
CIE_Y_INTEGRAL = float(np.sum(_CIE_XYZ[1]))  # ≈ 106.86 for the tabulated curves

# Classic pbrt XYZ↔RGB matrices (rgb_spectrum.rs:67-81) — standard CIE/sRGB
# primaries, public constants.
XYZ_TO_RGB = np.array(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ],
    dtype=np.float64,
)
RGB_TO_XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float64,
)


def xyz_to_rgb(xyz):
    return XYZ_TO_RGB @ np.asarray(xyz, dtype=np.float64)


def rgb_to_xyz(rgb):
    return RGB_TO_XYZ @ np.asarray(rgb, dtype=np.float64)


def luminance(rgb):
    rgb = np.asarray(rgb, dtype=np.float64)
    return 0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1] + 0.072169 * rgb[..., 2]


def spd_to_rgb(pairs) -> np.ndarray:
    """`pairs`: flat [λ0, v0, λ1, v1, ...] or (n,2) array → RGB (3,) f64.

    Piecewise-linear resample onto the 1 nm grid (clamped at the ends),
    integrate against CIE curves, normalize by ∫ȳ, convert to RGB — the
    reference's from_sampled (rgb_spectrum.rs:85-96).
    """
    a = np.asarray(pairs, dtype=np.float64).reshape(-1, 2)
    order = np.argsort(a[:, 0], kind="stable")
    lam, val = a[order, 0], a[order, 1]
    resampled = np.interp(_LAMBDAS, lam, val)  # clamps at endpoints
    xyz = _CIE_XYZ @ resampled
    scale = (_LAMBDAS[-1] - _LAMBDAS[0]) / (CIE_Y_INTEGRAL * N_SAMPLES)
    return xyz_to_rgb(xyz * scale)
