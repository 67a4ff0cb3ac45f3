"""Film accumulation and the differentiable reconstruction splat
(counterpart of the JAX package's ops/film.py).

Rays are laid out pixel-major — (pixels, spp) — so the box film is a
reshape + masked mean with no scatter. NaN radiance samples are dropped per
pixel and the remaining samples averaged, matching the reference's
render.rs:34-43.

`filter_splat` is the differentiable splat of the wider (triangle)
filter: the forward adds weighted radiance into pixels, the backward
gathers. Its forward is deterministic on every device: a stable sort of
the pixel ids lines each pixel's taps up in their input order, and a
fixed-shape sum over each pixel's run adds them, with no atomics (a CUDA
`index_add_` adds in whatever order its threads arrive, so two renders
could differ in their last bits).
"""

from __future__ import annotations

import torch

from curry_pbrt_tpu_torch.ops.math import gamma_correct


def accumulate_box(radiance, spp: int, return_nan_counts: bool = False):
    """radiance: (P·S, 3) pixel-major sample radiances → (P, 3) per-pixel
    means with NaN samples dropped; with return_nan_counts=True also (P,)
    int32 dropped-sample counts."""
    r = radiance.reshape(-1, spp, 3)
    bad = torch.any(torch.isnan(r), dim=-1, keepdim=True)
    r = torch.where(bad, 0.0, r)
    count = torch.sum((~bad).to(torch.float32), dim=1)
    # the spp-sample sum runs left to right, as XLA reduces it on the CPU
    total = r[:, 0]
    for s in range(1, spp):
        total = total + r[:, s]
    means = total / torch.clamp(count, min=1.0)
    if return_nan_counts:
        return means, torch.sum(bad[..., 0].to(torch.int32), dim=1)
    return means


def to_srgb_u8(image):
    """Gamma-corrected 8-bit quantization (film.rs:35-38 + image.rs:108-127:
    clamp(v·255 + 0.5, 0, 255) as u8)."""
    v = gamma_correct(torch.clamp(image, min=0.0))
    return torch.clamp(v * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)


# ---------------------------------------------------------------------------
# the filter splat


def _pixel_sums(values, pixel_ids, n_pixels: int):
    """(M, k) values → (n_pixels, k) per-pixel sums, added in the same
    order on every run.

    A stable sort groups the values by pixel; each value's rank in its
    pixel's run gives it a slot of its own in a dense (pixels, K, k) block
    (K the longest run), which a sum over K reduces. Only the pixels
    between the smallest and largest id get a block row."""
    out = torch.zeros((n_pixels, values.shape[1]), dtype=values.dtype, device=values.device)
    sid, perm = torch.sort(pixel_ids.long(), stable=True)
    lo, hi = int(sid[0]), int(sid[-1])
    band = sid - lo
    starts = torch.searchsorted(band, torch.arange(hi - lo + 1, device=sid.device))
    rank = torch.arange(sid.shape[0], device=sid.device) - starts[band]
    dense = torch.zeros((hi - lo + 1, int(rank.max()) + 1, values.shape[1]),
                        dtype=values.dtype, device=values.device)
    dense[band, rank] = values[perm]
    out[lo:hi + 1] = dense.sum(dim=1)
    return out


class _FilterSplat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, radiance, pixel_ids, weights, n_pixels):
        ctx.save_for_backward(pixel_ids, weights)
        sums = _pixel_sums(torch.cat([radiance * weights[:, None], weights[:, None]], dim=1),
                           pixel_ids, n_pixels)
        film, wsum = sums[:, :3].contiguous(), sums[:, 3].contiguous()
        ctx.mark_non_differentiable(wsum)
        return film, wsum

    @staticmethod
    def backward(ctx, g_film, _g_wsum):
        pixel_ids, weights = ctx.saved_tensors
        if g_film is None:
            return None, None, None, None
        # d film[p] / d radiance_i = w_i for p = pixel_ids[i]: a gather; ids
        # and weights get no gradient (sample positions are not parameters)
        return g_film[pixel_ids.long()] * weights[:, None], None, None, None


def filter_splat(radiance, pixel_ids, weights, n_pixels: int):
    """Add weighted radiance into a flat film.

    radiance: (M,3); pixel_ids: (M,) integer (already footprint-expanded);
    weights: (M,) → (film_rgb (n_pixels,3), film_w (n_pixels,)). The
    backward is the JAX custom VJP's: a gather of the film's cotangent
    times the weight; no gradient reaches the ids or the weights, and the
    weight sum's cotangent is dropped."""
    return _FilterSplat.apply(radiance, pixel_ids, weights.detach(), n_pixels)


def normalize_splat(film, wsum):
    return film / torch.clamp(wsum, min=1e-12)[:, None]


def triangle_taps(film_xy, radiance, xres: int, yres: int):
    """Expand each sample into its 4 tent-filter taps for `filter_splat`.

    film_xy: (M,2) continuous sample positions (pixel centres at integer
    coordinates, the generate_rays convention); radiance: (M,3). A radius-1
    triangle (tent) filter covers exactly the 2×2 integer pixels around the
    sample with bilinear weights w = (1-|dx|)(1-|dy|). Taps off the film
    get weight 0 (pbrt discards them); NaN samples get weight 0 on all taps
    (the box path's NaN drop, render.rs:34-40).

    Returns (rad (4M,3), pixel_ids (4M,) int32, weights (4M,)): ids clipped
    onto the film, weights detached (sample positions are not
    differentiable parameters; see filter_splat's backward)."""
    film_xy = film_xy.detach()
    fx, fy = film_xy[:, 0], film_xy[:, 1]
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx1 = fx - x0  # weight of the x0+1 tap
    wy1 = fy - y0
    bad = torch.any(torch.isnan(radiance), dim=-1)
    rad = torch.where(bad[:, None], 0.0, radiance)

    ids, ws = [], []
    for ax, ay in ((0, 0), (1, 0), (0, 1), (1, 1)):
        px = x0 + ax
        py = y0 + ay
        w = (wx1 if ax else 1.0 - wx1) * (wy1 if ay else 1.0 - wy1)
        inside = (px >= 0) & (px < xres) & (py >= 0) & (py < yres)
        w = torch.where(inside & ~bad, w, 0.0)
        pid = (torch.clamp(py, 0, yres - 1) * xres + torch.clamp(px, 0, xres - 1)).to(torch.int32)
        ids.append(pid)
        ws.append(w)
    return rad.repeat(4, 1), torch.cat(ids), torch.cat(ws).detach()
