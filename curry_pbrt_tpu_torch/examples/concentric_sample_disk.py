"""Dump 128 concentric disk samples of seeded uniform points, one value a
line (reference: examples/concentric_sample_disk.rs).

    python -m curry_pbrt_tpu_torch.examples.concentric_sample_disk
"""

import numpy as np
import torch

from curry_pbrt_tpu_torch.ops.math import concentric_sample_disk


def main(argv=None):
    u = torch.from_numpy(np.random.RandomState(0).rand(128, 2).astype(np.float32))
    for x, y in concentric_sample_disk(u).tolist():
        print(x)
        print(y)


if __name__ == "__main__":
    main()
