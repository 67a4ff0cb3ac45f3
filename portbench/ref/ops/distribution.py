"""Piecewise-constant 1-D/2-D sampling distributions.

CDF tables are built once host-side (numpy prefix sums, the same functions
as the JAX package's ops/distribution.py, kept as float32 numpy arrays);
`on(device)` gives the same tables as tensors, which a render makes once.
They are inverted with a binary search (`torch.searchsorted`), O(log n) per
lane, with no (lanes × n) intermediate: at a 4M-ray chunk a 256 × 512 map's
per-lane row gather would be 8.6 GB per tensor.

Semantics match the reference:
  pdf[i]     = f[i] / sum(f)                                   (discrete)
  cdf[i]     = prefix-sum(f)[i] / sum(f)                       (inclusive)
  sample(u)  = first i with u <= cdf[i]; remap = (cdf[i]-u)/pdf[i]
  continuous = (i + remap)/n with density pdf[i]*n

The index is exactly the JAX package's count of cdf entries below u,
clipped to n - 1: a CDF is non-decreasing, so that count is the left
insertion point of u. The row-conditional search of the 2-D table runs over
one flattened, globally increasing int64 key, row << 32 | bits(cdf): the
int32 bits of non-negative float32 values order as the values do.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.ref.dtypes import Float


def _on(table, device):
    return type(table)(*(torch.as_tensor(a, device=device) for a in table))


class Distribution1D(NamedTuple):
    """Host float32 tables (or, after on(device), tensors); n is static.
    pdf/cdf: (n,)."""

    pdf: np.ndarray  # discrete pdf (sums to 1)
    cdf: np.ndarray  # inclusive prefix cdf, cdf[-1] == 1
    f_sum: np.ndarray  # scalar: sum(f)/n (the reference's f_sum)

    @property
    def n(self) -> int:
        return self.pdf.shape[-1]

    def on(self, device) -> "Distribution1D":
        return _on(self, device)


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
    """The table on `like`'s device: a no-op for a table already there."""
    return torch.as_tensor(a, device=like.device)


def _search_value(u):
    """u with every lane that no CDF entry (all >= 0) lies below — u <= 0
    and NaN — set to +0.0: the same count, 0, and a non-negative sign bit."""
    return torch.where(u > 0, u, 0.0)


def _search_1d(cdf, u):
    """First index i with u <= cdf[i] (the count of cdf entries below u),
    clipped to n - 1. cdf (n,) non-decreasing, u (...)."""
    idx = torch.searchsorted(cdf, _search_value(u).contiguous(), side="left")
    return torch.clamp(idx, max=cdf.shape[-1] - 1)


def sample_1d_remap(dist: Distribution1D, u):
    """u: (...) → (idx, pdf, remap), each (...)."""
    cdf, pdf_t = _dev(dist.cdf, u), _dev(dist.pdf, u)
    idx = _search_1d(cdf, u)
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
    col_key: np.ndarray  # (R·C,) int64 row << 32 | bits(col_cdf): increasing

    @property
    def shape(self):
        return self.col_pdf.shape

    def on(self, device) -> "Distribution2D":
        return _on(self, device)


def _cdf_bits(x: np.ndarray) -> np.ndarray:
    """int64 of the float32 bits of non-negative values (-0.0 → 0)."""
    x = np.asarray(x, np.float32)
    return np.where(x > 0, x, np.float32(0)).astype(np.float32).view(np.int32).astype(np.int64)


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
    col_cdf = col_cdf.astype(Float)
    key = (np.arange(rows, dtype=np.int64)[:, None] << 32) | _cdf_bits(col_cdf)
    return Distribution2D(
        row_pdf=row_pdf.astype(Float),
        row_cdf=row_cdf.astype(Float),
        col_pdf=col_pdf.astype(Float),
        col_cdf=col_cdf,
        col_key=key.reshape(-1),
    )


def _search_rows(col_key, r_idx, u, cols: int):
    """Per lane, the first column c of row r_idx with u <= col_cdf[r_idx, c],
    clipped to cols - 1: one search over the flattened key."""
    bits = _search_value(u).contiguous().view(torch.int32).to(torch.int64)
    pos = torch.searchsorted(col_key, (r_idx << 32) | bits, side="left")
    return torch.clamp(pos - r_idx * cols, max=cols - 1)


def sample_2d_continuous(dist: Distribution2D, u):
    """u: (..., 2) → (xy: (..., 2) in [0,1]², density: (...)).

    xy[0] is the ROW coordinate, xy[1] the column (distribution.rs:110-123)."""
    rows, cols = dist.shape
    row_pdf, row_cdf = _dev(dist.row_pdf, u), _dev(dist.row_cdf, u)
    col_pdf, col_cdf = _dev(dist.col_pdf, u), _dev(dist.col_cdf, u)
    u0, u1 = u[..., 0], u[..., 1]
    r_idx = _search_1d(row_cdf, u0)
    r_pdf = row_pdf[r_idx]
    r_remap = (row_cdf[r_idx] - u0) / torch.where(r_pdf == 0, 1.0, r_pdf)
    x = (r_idx.to(torch.float32) + r_remap) / rows

    c_idx = _search_rows(_dev(dist.col_key, u), r_idx, u1, cols)
    c_pdf = col_pdf[r_idx, c_idx]
    c_cdfv = col_cdf[r_idx, c_idx]
    c_remap = (c_cdfv - u1) / torch.where(c_pdf == 0, 1.0, c_pdf)
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
