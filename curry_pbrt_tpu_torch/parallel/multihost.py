"""Rendering over many processes (counterpart of the JAX package's
parallel/multihost.py).

The JAX package runs one program per host under `jax.distributed` and a
global device mesh. Here every rank is a process of one torch.distributed
group: each compiles and plans the same scene on its own device (the
scene, tables and params replicated), renders its contiguous slab of the
pixels (parallel/mesh.render_chunk_sharded), and the film rows are gathered
so that every rank holds the whole image; rank 0 writes the PNG.

Launch one process per rank (on one host or several):

    python -m curry_pbrt_tpu_torch.parallel.multihost scene.pbrt \\
        --coordinator=host0:8476 --num-processes=2 --process-id=$ID

The backend follows the device: NCCL on cards, gloo on the CPU. NCCL
refuses two ranks on one card, so ranks that share a card take
`--backend gloo`.

Where the port differs from the JAX package (ROADMAP.md Queue 3):
  - the JAX path plans one chunk of all the padded pixels; the port renders
    a rank's slab in pieces of the plan's chunk_pixels (the 4M-ray render
    chunk), since a 16.7M-ray chunk does not fit one pass on the card;
  - the JAX sharded path renders the box film whatever the scene's filter;
    the port raises on `Film "filter" "triangle"` at more than one rank
    (parallel/mesh.check_film) instead of rendering a different image.
"""

from __future__ import annotations

import argparse
import subprocess
import tempfile
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from curry_pbrt_tpu_torch.ops import film as F
from curry_pbrt_tpu_torch.parallel.mesh import check_film, make_mesh, render_chunk_sharded
from curry_pbrt_tpu_torch.render import pixel_arrays, plan_render, resolve_device
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file
from curry_pbrt_tpu_torch.utils.imageio import write_png


def initialize(coordinator: Optional[str], num_processes: int, process_id: int,
               device="cuda", backend: Optional[str] = None):
    """Join the default process group of num_processes ranks as rank
    process_id (nothing to join at one process, or when the group is
    already initialised) → torch.distributed. coordinator: "host:port" of
    rank 0's TCP store, or an init URL ("tcp://…", "file://…") as it is.
    backend: "nccl" for cuda and "gloo" for cpu unless given."""
    dev = resolve_device(device)
    if num_processes > 1 and not dist.is_initialized():
        if coordinator is None:
            raise ValueError("more than one process needs a coordinator (host:port of rank 0)")
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                                init_method=(coordinator if "://" in coordinator
                                             else f"tcp://{coordinator}"),
                                world_size=num_processes, rank=process_id)
    return dist


def render_distributed(scene_path, overrides=None, coordinator=None, num_processes=1,
                       process_id=0, output=None, device="cuda", backend=None):
    """Render with the pixels sharded over every rank → the (yres, xres, 3)
    float32 image on every rank; rank 0 writes the PNG (`output`, or the
    scene's film filename) and prints its path. At one process outside a
    group, this is render_scene's image through the sharded path."""
    scene = compile_scene_file(scene_path, overrides)
    check_film(scene, dist.get_world_size() if dist.is_initialized() else num_processes)
    initialize(coordinator, num_processes, process_id, device, backend)
    mesh = make_mesh(device=device)
    plan = plan_render(scene, device=mesh.device)
    film = render_chunk_sharded(plan, mesh, scene.init_params, *pixel_arrays(plan))
    xres, yres = scene.settings.resolution
    img = film.cpu().numpy().reshape(yres, xres, 3)
    if mesh.rank == 0:
        path = output or scene.settings.filename
        write_png(path, F.to_srgb_u8(torch.from_numpy(img)).numpy())
        print(path)
    return img


def run_ranks(argv_of_rank: Callable[[int], Sequence[str]], n: int, timeout: float,
              env=None) -> List[Tuple[int, str, str]]:
    """Start one process per rank, all at once (argv_of_rank(rank) → its
    command), and wait for them → [(return code, stdout, stderr)] in rank
    order. When one rank fails the others are killed (they would wait in a
    collective until the backend's own timeout); at `timeout` seconds every
    rank still running is killed and TimeoutError raised. Their output goes
    to temporary files, so that no rank blocks on a full pipe."""
    logs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")) for _ in range(n)]
    procs = [subprocess.Popen(list(argv_of_rank(r)), stdout=out, stderr=err, text=True, env=env)
             for r, (out, err) in enumerate(logs)]
    deadline, timed_out = time.monotonic() + timeout, False
    try:
        while any(p.poll() is None for p in procs) and not any(p.returncode for p in procs):
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    results = []
    for p, (out, err) in zip(procs, logs):
        out.seek(0)
        err.seek(0)
        results.append((p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    if timed_out:
        tails = "\n".join(f"rank {r}: {e[-1500:]}" for r, (_, _, e) in enumerate(results))
        raise TimeoutError(f"rank processes still ran after {timeout} s; killed:\n{tails}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="render one scene over many processes")
    ap.add_argument("scene")
    ap.add_argument("--coordinator", default=None, help="host:port of rank 0 (or an init URL)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--spp", type=int)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="render device (default cuda; cpu runs the kernels' plain versions)")
    ap.add_argument("--backend", choices=["nccl", "gloo"],
                    help="collective backend (default: nccl on cuda, gloo on cpu; gloo for "
                         "ranks that share a card)")
    args = ap.parse_args(argv)
    overrides = {} if args.spp is None else {"spp": args.spp}
    try:
        render_distributed(args.scene, overrides, args.coordinator, args.num_processes,
                           args.process_id, args.output, args.device, args.backend)
    finally:
        # leave the group before the interpreter exits: a gloo group torn
        # down in the exit's destructors can abort the process
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
