"""Command-line interface.

`python -m curry_pbrt_tpu_torch.cli scene.pbrt --device cuda` mirrors the
JAX package's CLI (one positional scene path, prints the output filename)
with an explicit render device. The default device is `cuda`, and it must
be there: the port does not fall back to the CPU.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="curry-pbrt-torch", description="pbrt-dialect path tracer (PyTorch + CUDA)"
    )
    ap.add_argument("scene", help="pbrt scene file")
    ap.add_argument("-o", "--output", help="output PNG path (default: scene Film filename)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="render device (default cuda; cpu runs the kernels' plain versions)")
    ap.add_argument("--spp", type=int, help="samples per pixel override")
    ap.add_argument("--res", type=int, nargs=2, metavar=("X", "Y"), help="resolution override")
    ap.add_argument("--max-depth", type=int, help="path depth override")
    ap.add_argument("--seed", type=int, default=0, help="sampler scramble seed")
    ap.add_argument("--no-clip", action="store_true", help="disable camera frustum culling")
    ap.add_argument("--chunk-pixels", type=int, help="pixels per device batch")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    overrides = {"seed": args.seed}
    if args.spp is not None:
        overrides["spp"] = args.spp
    if args.res is not None:
        overrides["resolution"] = tuple(args.res)
    if args.max_depth is not None:
        overrides["max_depth"] = args.max_depth
    if args.no_clip:
        overrides["clip"] = False

    from curry_pbrt_tpu_torch.render import render_from_file

    render_from_file(
        args.scene,
        output=args.output,
        overrides=overrides,
        device=args.device,
        chunk_pixels=args.chunk_pixels,
        show_progress=not args.quiet,
    )


if __name__ == "__main__":
    main()
