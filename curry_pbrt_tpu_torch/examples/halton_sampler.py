"""Dump 128 Halton 2-D samples (dims 2 and 3, sample k of pixel (0, 0) of
a 1024x768 film at 128 spp) for external plotting, one value a line
(reference: examples/halton_sampler.rs).

    python -m curry_pbrt_tpu_torch.examples.halton_sampler
"""

import torch

from curry_pbrt_tpu_torch.ops import halton as h


def main(argv=None):
    cfg = h.make_halton_config((1024, 768), spp=128)
    perms = h.make_permutations(cfg.seed)
    # uint32 indices k · scale_prod, wrapped as the sampler's are
    idx = (torch.arange(128, dtype=torch.int64) * cfg.scale_prod) & 0xFFFFFFFF
    for x, y in h.halton_sample_2d(idx, 2, cfg, perms).tolist():
        print(x)
        print(y)


if __name__ == "__main__":
    main()
