"""The slab-grid probe (P): the CUDA kernel of csrc/slab_grid.cu, its plain
PyTorch version, and the probe that holds one against the other.

Counterpart of the JAX package's tools/probe_slab_grid.py (`run`): over a
(ray blocks × slabs) grid,

    out[0, i] = Σ_j ( tab[8 j, 0] · Σ slabs[j·slab_rows:(j+1)·slab_rows] + rays[0, i] )

with tab (8·S, 4), rays (4, block_rays·B), slabs (slab_rows·S, 8) float32 →
out (1, block_rays·B). The JAX shapes are the defaults (block_rays 256,
slab_rows 8, 2 blocks, 3 slabs). The kernel (`slab_grid`) and the plain
version sum each slab in the same order, so they are bit-equal; the first
port (`slab_grid_baseline`, the A/B baseline) sums serially and agrees
within rtol 1e-5, the JAX probe's own check, which `run` applies to both.

    python -m curry_pbrt_tpu_torch.tools.probe_slab_grid [--blocks B --slabs S] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from curry_pbrt_tpu_torch.ops.kernels.intersect_kernel import LAUNCHES

BLOCK_RAYS, SLAB_ROWS = 256, 8
RTOL = 1e-5


def make_inputs(n_blocks: int = 2, n_slabs: int = 3, block_rays: int = BLOCK_RAYS,
                slab_rows: int = SLAB_ROWS, device="cpu"):
    """The JAX probe's inputs (tools/probe_slab_grid.py:35-38) at any shape:
    (tab, rays, slabs)."""
    rays = torch.arange(4 * n_blocks * block_rays, dtype=torch.float32).reshape(
        4, n_blocks * block_rays) * 0.001
    slabs = torch.arange(n_slabs * slab_rows * 8, dtype=torch.float32).reshape(
        n_slabs * slab_rows, 8) * 0.01
    tab = torch.repeat_interleave(torch.arange(n_slabs, dtype=torch.float32) + 1.0,
                                  8 * 4).reshape(n_slabs * 8, 4)
    return tab.to(device), rays.to(device), slabs.to(device)


def slab_sum(values):
    """Σ of a 1-D float32 tensor in the kernel's order: lane l of a warp adds
    values l, l + 32, ... left to right, then a butterfly over the 32 lanes
    (xor 16, 8, 4, 2, 1); every lane ends with lane 0's value."""
    lanes = torch.nn.functional.pad(values, (0, (-values.numel()) % 32)).reshape(-1, 32)
    acc = torch.zeros(32, dtype=torch.float32, device=values.device)
    for row in lanes:
        acc = acc + row
    idx = torch.arange(32, device=values.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[idx ^ off]
    return acc[0]


def slab_grid_plain(tab, rays, slabs, *, slab_rows: int = SLAB_ROWS):
    """Plain version: the JAX probe's numpy reference
    (tools/probe_slab_grid.py:56-66) in torch, each slab summed in the
    kernel's order (slab_sum) → (1, N), bit-equal to the kernel."""
    n_slabs = tab.shape[0] // 8
    acc = torch.zeros(rays.shape[1], dtype=torch.float32, device=rays.device)
    for j in range(n_slabs):
        scaled = tab[j * 8, 0] * slab_sum(slabs[j * slab_rows:(j + 1) * slab_rows].reshape(-1))
        acc = acc + (scaled + rays[0])
    return acc[None]


def _launch(entry: str, counter: str, tab, rays, slabs, block_rays: int, slab_rows: int):
    n_slabs = tab.shape[0] // 8
    n = rays.shape[1]
    if (tab.shape != (8 * n_slabs, 4) or rays.shape != (4, n)
            or slabs.shape != (slab_rows * n_slabs, 8) or n % block_rays):
        raise ValueError(f"shapes disagree: tab {tuple(tab.shape)}, rays {tuple(rays.shape)}, "
                         f"slabs {tuple(slabs.shape)}, block_rays {block_rays}")
    if any(x.dtype != torch.float32 or x.device != rays.device for x in (tab, slabs)):
        raise TypeError("P takes float32 tensors on one device")
    if rays.device.type == "cpu":
        return slab_grid_plain(tab, rays, slabs, slab_rows=slab_rows)
    if rays.device.type != "cuda":
        raise ValueError(f"no slab-grid kernel for device {rays.device}")
    from curry_pbrt_tpu_torch.ops.kernels.build import load_library

    out = torch.empty((1, n), dtype=torch.float32, device=rays.device)
    if n == 0:
        return out
    keep = [x.contiguous() for x in (tab, rays, slabs)]
    err = getattr(load_library(), entry)(
        *(x.data_ptr() for x in keep), n_slabs, slab_rows, block_rays, n, out.data_ptr(),
        torch.cuda.current_stream(rays.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    LAUNCHES[counter] += 1
    return out


def slab_grid(tab, rays, slabs, *, block_rays: int = BLOCK_RAYS, slab_rows: int = SLAB_ROWS):
    """P → (1, N) float32. CPU tensors → plain version; CUDA tensors → the
    CUDA kernel (a grid sized to the card, 16-byte loads and stores: N a
    multiple of 4 and row 0 of rays 16-byte aligned, or it raises)."""
    return _launch("curry_slab_grid", "slab_grid", tab, rays, slabs, block_rays, slab_rows)


def slab_grid_baseline(tab, rays, slabs, *, block_rays: int = BLOCK_RAYS,
                       slab_rows: int = SLAB_ROWS):
    """P through the first port (one CTA per block of block_rays rays), the
    A/B baseline; the same contract as slab_grid."""
    return _launch("curry_slab_grid_baseline", "slab_grid_baseline", tab, rays, slabs,
                   block_rays, slab_rows)


def run(n_blocks: int = 2, n_slabs: int = 3, device="cuda", block_rays: int = BLOCK_RAYS,
        slab_rows: int = SLAB_ROWS, kernel=None):
    """P (`kernel`: slab_grid by default, or slab_grid_baseline) against its
    plain version on the JAX probe's inputs at this shape → (out, max |Δ|,
    max relative Δ); raises beyond rtol 1e-5."""
    inputs = make_inputs(n_blocks, n_slabs, block_rays, slab_rows, device)
    out = (kernel or slab_grid)(*inputs, block_rays=block_rays, slab_rows=slab_rows)
    ref = slab_grid_plain(*inputs, slab_rows=slab_rows)
    if not torch.allclose(out, ref, rtol=RTOL, atol=0.0):
        raise AssertionError(f"P disagrees with its plain version beyond rtol {RTOL}")
    diff = (out - ref).abs()
    return out, float(diff.max()), float((diff / ref.abs().clamp(min=1e-30)).max())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--slabs", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out, err, rel = run(args.blocks, args.slabs, args.device)
    print(f"P {args.blocks} blocks x {args.slabs} slabs on {args.device}: out[0, :4] "
          f"{out[0, :4].tolist()}, max |d| {err:.3g} (rel {rel:.3g}) vs plain — OK")


if __name__ == "__main__":
    main()
