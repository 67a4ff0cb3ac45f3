"""Sharding overhead and scaling over rank processes (counterpart of the JAX
package's tools/scaling_bench.py).

Renders the same fixed workload (one scene, resolution, spp and depth) at
each world size of --ranks, one process per rank (parallel/multihost.py's
launcher; parallel/mesh.render_chunk_sharded over the whole film), and
reports each size's wall (the median of --passes timed passes after a
warm-up, each ending in a sync), camera rays per second and the overhead
proxy wall_1 / wall_N, and the largest difference of each size's image from
the first size's. Prints one JSON line. The regimes:

  * the CPU: the ranks share the host's cores (each rank takes its share of
    the intra-op threads) and use gloo, as the JAX package's virtual
    devices share them; wall_1 / wall_N measures what sharding adds to the
    same total work, not scaling;
  * cards, one rank a card (NCCL): scaling_efficiency = rays/s at N over N
    times rays/s at 1 is a scaling number;
  * more ranks than cards: the ranks share a card over gloo (NCCL refuses
    two ranks on one card); the line says "ranks sharing one card" and
    carries no scaling efficiency — one card cannot measure scaling over
    cards.

    python -m curry_pbrt_tpu_torch.tools.scaling_bench [--scene cornell.pbrt]
        [--res 128] [--spp 8] [--depth 3] [--ranks 1 2 4] [--passes 3]
        [--device cuda|cpu] [--out build/scaling]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import uuid
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
RANK_TIMEOUT_S = 900.0  # a world size's ranks are killed, and the tool fails, after this


def _workload_args(args):
    return ["--scene", args.scene, "--res", str(args.res), "--spp", str(args.spp), "--depth",
            str(args.depth), "--passes", str(args.passes), "--device", args.device,
            "--out", str(args.out)]


def worker(args) -> None:
    """One rank: join the group, plan, a warm-up render, then the timed
    passes; rank 0 writes result_<N>.json and image_<N>.npy into --out."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from curry_pbrt_tpu_torch.parallel.mesh import make_mesh, make_sharded_render
    from curry_pbrt_tpu_torch.render import pixel_arrays, plan_render
    from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file

    world, rank = args.world, args.rank
    on_card = args.device == "cuda"
    if not on_card:  # the host's cores are shared out over the ranks
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    backend = "nccl" if on_card and world <= torch.cuda.device_count() else "gloo"
    dist.init_process_group(backend, init_method=args.init, world_size=world, rank=rank)
    try:
        mesh = make_mesh(world, device=args.device)
        scene = compile_scene_file(REPO / "scenes" / args.scene, overrides={
            "resolution": (args.res, args.res), "spp": args.spp, "max_depth": args.depth})
        plan = plan_render(scene, device=mesh.device)
        po, px = pixel_arrays(plan)
        render = make_sharded_render(plan, mesh)

        def sync():
            if on_card:
                torch.cuda.synchronize(mesh.device)

        img = render(scene.init_params, po, px)  # warm-up
        walls = []
        for _ in range(args.passes):
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            img = render(scene.init_params, po, px)
            sync()
            walls.append(time.perf_counter() - t0)
        if rank == 0:
            np.save(args.out / f"image_{world}.npy", img.cpu().numpy())
            (args.out / f"result_{world}.json").write_text(json.dumps(
                {"walls_s": walls, "backend": backend}))
    finally:
        dist.destroy_process_group()


def regime(device: str, sizes, n_cards: int) -> str:
    if device == "cpu":
        return "ranks sharing the host's cores"
    if max(sizes) <= n_cards:
        return "one card per rank"
    return "ranks sharing one card" if n_cards == 1 else f"ranks sharing {n_cards} cards"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="cornell.pbrt")
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", type=Path, default=REPO / "build" / "scaling")
    # a rank process (started by main)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--init", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    args.out = args.out.resolve()  # the file store's URL needs an absolute path
    if args.worker:
        return worker(args)

    import numpy as np
    import torch

    from curry_pbrt_tpu_torch.parallel.multihost import run_ranks
    from curry_pbrt_tpu_torch.render import resolve_device

    resolve_device(args.device)  # no card: raise here, before any rank starts
    card, n_cards = "cpu", 0
    if args.device == "cuda":
        from curry_pbrt_tpu_torch.ops.kernels.build import build
        from curry_pbrt_tpu_torch.tools.roofline import nvidia_smi

        build()  # once, before the ranks start (each would build it)
        card, n_cards = nvidia_smi("name,power.limit"), torch.cuda.device_count()
    args.out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    rays = args.res * args.res * args.spp
    sizes, results, images = args.ranks, {}, {}
    for n in sizes:
        init = f"file://{args.out / f'store_{n}_{uuid.uuid4().hex}'}"

        def argv_of_rank(rank, n=n, init=init):
            return [sys.executable, "-m", "curry_pbrt_tpu_torch.tools.scaling_bench", "--worker",
                    "--rank", str(rank), "--world", str(n), "--init", init,
                    *_workload_args(args)]

        for rank, (rc, out, err) in enumerate(run_ranks(argv_of_rank, n, RANK_TIMEOUT_S, env=env)):
            if rc != 0:
                raise RuntimeError(f"rank {rank} of {n} failed ({rc}):\n{out[-2000:]}\n"
                                   f"{err[-4000:]}")
        res = json.loads((args.out / f"result_{n}.json").read_text())
        images[n] = np.load(args.out / f"image_{n}.npy")
        wall = statistics.median(res["walls_s"])
        results[n] = {"backend": res["backend"], "walls_s": res["walls_s"], "wall_s": wall,
                      "rays_per_sec": rays / wall,
                      "max_abs_diff_vs_first": float(np.abs(images[n] - images[sizes[0]]).max())}
    shared = regime(args.device, sizes, n_cards)
    base = results[sizes[0]]
    for n in sizes:
        r = results[n]
        r["wall_1_over_wall_n"] = base["wall_s"] / r["wall_s"]
        r["scaling_efficiency"] = (r["rays_per_sec"] / (n / sizes[0] * base["rays_per_sec"])
                                   if shared == "one card per rank" else None)
    print(json.dumps({
        "regime": shared, "device": args.device, "card": card,
        "workload": {"scene": args.scene, "res": args.res, "spp": args.spp, "depth": args.depth,
                     "camera_rays": rays, "passes": args.passes},
        "ranks": {str(n): results[n] for n in sizes},
    }))


if __name__ == "__main__":
    main()
