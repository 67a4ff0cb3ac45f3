"""Film accumulation (counterpart of the JAX package's ops/film.py, box
filter only; the triangle-filter splat waits for ROADMAP Queue 1 item 11).

Rays are laid out pixel-major — (pixels, spp) — so accumulation is a
reshape + masked mean with no scatter. NaN radiance samples are dropped per
pixel and the remaining samples averaged, matching the reference's
render.rs:34-43.
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
