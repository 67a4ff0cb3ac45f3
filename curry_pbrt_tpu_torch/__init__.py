"""curry_pbrt_tpu_torch — the PyTorch + CUDA port of curry_pbrt_tpu.

Same renderer (pbrt scene dialect, Halton sampling, MIS next-event path
tracing, box film) written as plain PyTorch tensor code, with the ray
traversal kernels hand-written in CUDA C++ for Hopper (csrc/). The JAX
package beside it is the reference the port is tested against.
"""

__version__ = "0.1.0"

# Geometry transforms are tiny 3/4-wide contractions where TF32 rounding
# (~1e-3 relative) would corrupt shadow-ray origins into self-occlusion;
# keep every float32 product in full precision (the JAX package forces
# "highest" matmul precision for the same reason).
import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")


def __getattr__(name):
    # lazy, so `import curry_pbrt_tpu_torch.ops.math` stays cheap
    if name in ("render_from_file", "render_scene"):
        from curry_pbrt_tpu_torch import render

        return getattr(render, name)
    raise AttributeError(name)
