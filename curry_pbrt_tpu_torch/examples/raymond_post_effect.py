"""Swirl post-effect over an image — the vectorized equivalent of the
reference's per-pixel example (examples/raymond_post_effect.rs): pixels
within `radius` of the center sample from a rotated source position, the
rotation falling off with distance.

    python -m curry_pbrt_tpu_torch.examples.raymond_post_effect in.png out.png
"""

import sys

import numpy as np
import torch

from curry_pbrt_tpu_torch.ops.film import to_srgb_u8
from curry_pbrt_tpu_torch.utils.imageio import read_image, write_png


def post_effect(img: np.ndarray, radius=200.0, c=300.0) -> np.ndarray:
    h, w = img.shape[:2]
    cy, cx = h / 2.0, w / 2.0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    dx, dy = xs - cx, ys - cy
    dist = np.sqrt(dx * dx + dy * dy)
    angle = np.arctan2(dy, dx)
    na = angle + np.deg2rad(c * (1.0 - dist / radius))
    sx = np.clip((cx + np.cos(na) * dist).astype(np.int32), 0, w - 1)
    sy = np.clip((cy + np.sin(na) * dist).astype(np.int32), 0, h - 1)
    out = img.copy()
    mask = dist <= radius
    out[mask] = img[sy[mask], sx[mask]]
    return out


def main(argv=None):
    src, dst = (sys.argv[1:] if argv is None else argv)[:2]
    out = post_effect(read_image(src))
    write_png(dst, to_srgb_u8(torch.from_numpy(out)).numpy())


if __name__ == "__main__":
    main()
