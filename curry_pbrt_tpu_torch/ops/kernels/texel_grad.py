"""The texel gather's backward: `TexelGather`, the row gather of
models/materials.eval_texref as an autograd Function, and `texel_grad`, the
wrapper of its backward kernel in csrc/texel_grad.cu, with its plain
PyTorch version.

It replaces no Pallas kernel: the JAX package leaves this VJP to XLA's
scatter-add. It was added because PyTorch's backward of a row gather,
index_put_(accumulate=True), sorts the ids and then adds each run of equal
ids in one thread per channel, in series; in an inverse-rendering step one
texel holds up to half of a bounce's 4,194,304 rows, so one thread's walk
set the step's time. Its bound is bytes, about 24 a row (the sorted id, the
permutation, the gradient row read through it). The design (the kernel's
source says more) sorts the ids stably (torch.sort) and sums each run over
fixed tiles of the sorted rows: every CTA does the same work whatever the
duplication, and every texel's sum has one fixed order, with no float
atomics, so the gradient is bit-equal from run to run.

For CPU tensors `texel_grad` runs the plain version, which is what autograd
computes for the plain gather: the same gradients to the bit. For CUDA
tensors it launches the kernel or raises. Launches are counted in
intersect_kernel.LAUNCHES["texel_grad"] (one a backward).
"""

from __future__ import annotations

import math

import torch

from curry_pbrt_tpu_torch.ops.kernels.intersect_kernel import LAUNCHES


def texel_grad_plain(ids, grad, n_texels: int):
    """Σ of grad's rows (N, 3) by ids (N,) → (n_texels, 3): the plain
    version, PyTorch's scatter-add (index_put_ with accumulate)."""
    out = torch.zeros((n_texels, 3), dtype=grad.dtype, device=grad.device)
    return out.index_put_((ids.long(),), grad, accumulate=True)


def texel_grad(ids, grad, n_texels: int):
    """Σ of grad's rows by texel id → (n_texels, 3). ids: (N,) int32 in
    [0, n_texels); grad: (N, 3). CPU tensors → the plain version; CUDA
    tensors → a stable sort of the ids and the segment sum of
    csrc/texel_grad.cu (float32)."""
    if ids.ndim != 1 or grad.shape != (ids.shape[0], 3) or ids.device != grad.device:
        raise ValueError(f"texel_grad takes ids (N,) and grad (N, 3) on one device; got "
                         f"{tuple(ids.shape)} on {ids.device}, {tuple(grad.shape)} on "
                         f"{grad.device}")
    if ids.device.type == "cpu":
        return texel_grad_plain(ids, grad, n_texels)
    if ids.dtype != torch.int32 or grad.dtype != torch.float32:
        raise ValueError(f"the texel_grad kernel takes int32 ids and float32 rows; got "
                         f"{ids.dtype}, {grad.dtype}")
    n = ids.shape[0]
    if n > 2**31 - 1 - 4096 or n_texels > 2**31 - 1:  # a tile's end stays below 2**31
        raise ValueError(f"the texel_grad kernel indexes rows with 32-bit ints; got {n} rows "
                         f"and {n_texels} texels")
    from curry_pbrt_tpu_torch.ops.kernels.build import load_library

    lib = load_library()
    dev = ids.device
    sorted_ids, perm = torch.sort(ids, stable=True)
    grad = grad.contiguous()
    out = torch.zeros((n_texels, 3), dtype=torch.float32, device=dev)
    rows = lib.curry_texel_grad_carry_rows(n)
    carry_ids = torch.empty((rows,), dtype=torch.int32, device=dev)
    carry_vals = torch.empty((rows, 3), dtype=torch.float32, device=dev)
    err = lib.curry_texel_grad(sorted_ids.data_ptr(), perm.data_ptr(), grad.data_ptr(), n,
                               n_texels, out.data_ptr(), carry_ids.data_ptr(),
                               carry_vals.data_ptr(), rows,
                               torch.cuda.current_stream(dev).cuda_stream)
    # the inputs and scratch may be freed now: the caching allocator reuses
    # their memory only for work queued after these launches on this stream
    if err != 0:
        raise RuntimeError(f"curry_texel_grad kernel launch failed: CUDA error {err}")
    if n:  # no row, no segment-sum launch
        LAUNCHES["texel_grad"] += 1
    return out


class TexelGather(torch.autograd.Function):
    """img (H, W, 3), ids (N,) int64 flat texel ids → img.reshape(-1, 3)[ids]
    (N, 3), the plain gather; it saves the ids as int32 and its backward is
    texel_grad."""

    @staticmethod
    def forward(ctx, img, ids):
        ctx.save_for_backward(ids.to(torch.int32))
        ctx.img_shape = img.shape
        return img.reshape(-1, 3)[ids]

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        with torch.profiler.record_function("texel_grad"):
            g = texel_grad(ids, grad, math.prod(ctx.img_shape[:-1]))
        return g.reshape(ctx.img_shape), None
