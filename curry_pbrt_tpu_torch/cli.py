"""Command-line interface.

`python -m curry_pbrt_tpu_torch.cli scene.pbrt --device cuda` mirrors the
JAX package's CLI (one positional scene path, prints the output filename)
with an explicit render device. The default device is `cuda`, and it must
be there: the port does not fall back to the CPU. To render one scene over
several processes (one rank a card, or ranks sharing a card), launch
`python -m curry_pbrt_tpu_torch.parallel.multihost` once per rank.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="curry-pbrt-torch", description="pbrt-dialect path tracer (PyTorch + CUDA)",
        epilog="over several processes: python -m curry_pbrt_tpu_torch.parallel.multihost",
    )
    ap.add_argument("scene", help="pbrt scene file")
    ap.add_argument("-o", "--output", help="output PNG path (default: scene Film filename)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="render device (default cuda; cpu runs the kernels' plain versions)")
    ap.add_argument("--spp", type=int, help="samples per pixel override")
    ap.add_argument("--res", type=int, nargs=2, metavar=("X", "Y"), help="resolution override")
    ap.add_argument("--max-depth", type=int, help="path depth override")
    ap.add_argument("--integrator", choices=["path", "directlighting"])
    ap.add_argument("--filter", choices=["box", "triangle"],
                    help="reconstruction filter override")
    ap.add_argument("--seed", type=int, default=0, help="sampler scramble seed")
    ap.add_argument("--no-clip", action="store_true", help="disable camera frustum culling")
    ap.add_argument("--chunk-pixels", type=int, help="pixels per device batch")
    ap.add_argument("--intersector", default="kernel", choices=["kernel", "brute", "bvh"],
                    help="traversal kernels over cluster tables (default), brute force "
                         "(every ray against every primitive: small scenes, the oracle) or "
                         "the flat BVH (the oracle at mesh scale)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    overrides = {"seed": args.seed}
    if args.spp is not None:
        overrides["spp"] = args.spp
    if args.res is not None:
        overrides["resolution"] = tuple(args.res)
    if args.max_depth is not None:
        overrides["max_depth"] = args.max_depth
    if args.integrator is not None:
        overrides["integrator"] = args.integrator
    if args.filter is not None:
        overrides["filter"] = args.filter
    if args.no_clip:
        overrides["clip"] = False

    from curry_pbrt_tpu_torch.render import render_from_file

    render_from_file(
        args.scene,
        output=args.output,
        overrides=overrides,
        device=args.device,
        chunk_pixels=args.chunk_pixels,
        intersector=args.intersector,
        show_progress=not args.quiet,
    )


if __name__ == "__main__":
    main()
