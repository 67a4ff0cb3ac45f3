"""Piecewise-constant 1-D/2-D sampling distributions.

CDF tables are built once host-side (numpy prefix sums, the same functions
as the JAX package's ops/distribution.py, kept as float32 numpy arrays) and
inverted on the device by counting cdf entries below u — O(n) per lane, no
data-dependent loops.

Semantics match the reference:
  pdf[i]     = f[i] / sum(f)                                   (discrete)
  cdf[i]     = prefix-sum(f)[i] / sum(f)                       (inclusive)
  sample(u)  = first i with u <= cdf[i]; remap = (cdf[i]-u)/pdf[i]
  continuous = (i + remap)/n with density pdf[i]*n
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from curry_pbrt_tpu_torch.dtypes import Float


class Distribution1D(NamedTuple):
    """Host float32 tables; n is static. pdf/cdf: (n,)."""

    pdf: np.ndarray  # discrete pdf (sums to 1)
    cdf: np.ndarray  # inclusive prefix cdf, cdf[-1] == 1
    f_sum: np.ndarray  # scalar: sum(f)/n (the reference's f_sum)

    @property
    def n(self) -> int:
        return self.pdf.shape[-1]


def build_distribution_1d(f: np.ndarray) -> Distribution1D:
    f = np.asarray(f, dtype=np.float64)
    n = f.shape[-1]
    assert n > 0
    cdf = np.cumsum(f / n, axis=-1)
    f_sum = cdf[..., -1:]
    safe = np.where(f_sum == 0, 1.0, f_sum)
    pdf = (f / n) / safe
    cdf = cdf / safe
    return Distribution1D(
        pdf=pdf.astype(Float), cdf=cdf.astype(Float), f_sum=f_sum[..., 0].astype(Float)
    )


def _dev(a, like):
    return torch.as_tensor(a, device=like.device)


def _searchsorted_rows(cdf, u):
    """First index i with u <= cdf[i]; cdf (..., n), u (...)."""
    return torch.clamp(
        torch.sum((cdf < u[..., None]).to(torch.int32), dim=-1), 0, cdf.shape[-1] - 1
    ).long()


def sample_1d_remap(dist: Distribution1D, u):
    """u: (...) → (idx, pdf, remap), each (...)."""
    cdf, pdf_t = _dev(dist.cdf, u), _dev(dist.pdf, u)
    idx = _searchsorted_rows(cdf, u)
    pdf = pdf_t[idx]
    remap = (cdf[idx] - u) / torch.where(pdf == 0, 1.0, pdf)
    return idx, pdf, remap


def sample_1d_continuous(dist: Distribution1D, u):
    """u: (...) → (idx, density, x∈[0,1])."""
    n = float(dist.n)
    idx, pdf, remap = sample_1d_remap(dist, u)
    return idx, pdf * n, (idx.to(torch.float32) + remap) / n


def pdf_1d_continuous(dist: Distribution1D, x):
    n = dist.n
    idx = torch.clamp((x * n).to(torch.int32), 0, n - 1).long()
    return _dev(dist.pdf, x)[idx] / float(n)


class Distribution2D(NamedTuple):
    """Row-major table: rows along axis 0 (the reference samples the ROW
    index from u.x and the column from u.y — distribution.rs:100-123)."""

    row_pdf: np.ndarray  # (R,) marginal over rows
    row_cdf: np.ndarray  # (R,)
    col_pdf: np.ndarray  # (R, C) per-row conditional
    col_cdf: np.ndarray  # (R, C)

    @property
    def shape(self):
        return self.col_pdf.shape


def build_distribution_2d(f: np.ndarray) -> Distribution2D:
    f = np.asarray(f, dtype=np.float64)
    rows, cols = f.shape
    col_cdf = np.cumsum(f / cols, axis=-1)
    row_sums = col_cdf[:, -1].copy()
    safe = np.where(row_sums == 0, 1.0, row_sums)[:, None]
    col_pdf = (f / cols) / safe
    col_cdf = col_cdf / safe
    row_cdf = np.cumsum(row_sums / rows)
    total = row_cdf[-1] if row_cdf[-1] != 0 else 1.0
    row_pdf = (row_sums / rows) / total
    row_cdf = row_cdf / total
    return Distribution2D(
        row_pdf=row_pdf.astype(Float),
        row_cdf=row_cdf.astype(Float),
        col_pdf=col_pdf.astype(Float),
        col_cdf=col_cdf.astype(Float),
    )


def sample_2d_continuous(dist: Distribution2D, u):
    """u: (..., 2) → (xy: (..., 2) in [0,1]², density: (...)).

    xy[0] is the ROW coordinate, xy[1] the column (distribution.rs:110-123)."""
    rows, cols = dist.shape
    row_pdf, row_cdf = _dev(dist.row_pdf, u), _dev(dist.row_cdf, u)
    col_pdf, col_cdf = _dev(dist.col_pdf, u), _dev(dist.col_cdf, u)
    r_idx = _searchsorted_rows(row_cdf, u[..., 0])
    r_pdf = row_pdf[r_idx]
    r_remap = (row_cdf[r_idx] - u[..., 0]) / torch.where(r_pdf == 0, 1.0, r_pdf)
    x = (r_idx.to(torch.float32) + r_remap) / rows

    row_col_cdf = col_cdf[r_idx]  # (..., C)
    row_col_pdf = col_pdf[r_idx]
    c_idx = _searchsorted_rows(row_col_cdf, u[..., 1])
    c_pdf = torch.gather(row_col_pdf, -1, c_idx[..., None])[..., 0]
    c_cdfv = torch.gather(row_col_cdf, -1, c_idx[..., None])[..., 0]
    c_remap = (c_cdfv - u[..., 1]) / torch.where(c_pdf == 0, 1.0, c_pdf)
    y = (c_idx.to(torch.float32) + c_remap) / cols

    density = (r_pdf * rows) * (c_pdf * cols)
    return torch.stack([x, y], dim=-1), density


def pdf_2d_continuous(dist: Distribution2D, xy):
    rows, cols = dist.shape
    r = torch.clamp((xy[..., 0] * rows).to(torch.int32), 0, rows - 1).long()
    c = torch.clamp((xy[..., 1] * cols).to(torch.int32), 0, cols - 1).long()
    rp = _dev(dist.row_pdf, xy)[r]
    cp = _dev(dist.col_pdf, xy)[r, c]
    return rp * cp * rows * cols
