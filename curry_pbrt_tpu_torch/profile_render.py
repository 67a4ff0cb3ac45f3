"""Profile one render on the card: where the device time goes, by op.

    python -m curry_pbrt_tpu_torch.profile_render SCENE [--res W H] [--spp N]
        [--max-depth D] [--top 12] [--passes N] [--sort-compare] [--grad]

Compiles and plans the scene once (both printed as set-up seconds), renders
one warm-up pass, then one pass under torch.profiler (CPU and CUDA
activities) and prints: the wall under the profiler, the device's busy time
(the sum of kernel times; one stream, so kernels do not overlap) and its
share of the wall, the number of kernel launches, and the top ops by self
device time — PyTorch ops (`aten::*`) and the port's own kernels
(`curry::*`). --passes N then times N unprofiled passes; --sort-compare
times unprofiled passes with the aggregate's ray sort on and off, in the
order on, off, off, on.

--grad profiles one gradient pass of the inverse-rendering step instead
(parallel/mesh.py: the image MSE against the warm-up render, the scene's
first texture reset to 0.5 as the one leaf that requires grad — the
texture-recovery task of BASELINE config 4), after one unprofiled pass:
its forward and backward seconds apart (synchronized), the peak device
memory, and the same device table over both.

Needs a card; writes the profiler's full table to build/profiles/.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

from curry_pbrt_tpu_torch.render import plan_render, render_plan
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file

OUT_DIR = Path(__file__).resolve().parents[1] / "build" / "profiles"


def _device_ms(evt) -> float:
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
        us = evt.self_cuda_time_total
    return us / 1e3


def _timed(plan) -> tuple:
    torch.cuda.synchronize()
    t0 = time.time()
    img, segments = render_plan(plan, show_progress=False, count_rays=True)
    torch.cuda.synchronize()
    return time.time() - t0, segments, float(img.astype("float64").sum())


def _report(name, prof, wall, top, tag) -> float:
    """Print the device busy time, launches and top ops of a profile; write
    its full table under build/profiles/. Returns the busy ms."""
    ka = prof.key_averages()
    kernels = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(_device_ms(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"[{name}] profiled{tag} pass: wall {wall:.3f} s, device busy {busy / 1e3:.3f} s "
          f"({busy / 1e3 / wall:.1%} of the wall), {launches} kernel launches", flush=True)
    ops = [e for e in ka if e.key.startswith("aten::")] + [e for e in kernels if "curry" in e.key]
    ops.sort(key=_device_ms, reverse=True)
    print(f"[{name}] top ops by self device time (ms, share of busy, calls):")
    for e in ops[:top]:
        print(f"  {e.key[:60]:60s} {_device_ms(e):10.2f} {_device_ms(e) / busy:7.1%} {e.count:8d}")
    host = sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)
    print(f"[{name}] top ops by self host time (ms, calls):")
    for e in host[:top]:
        print(f"  {e.key[:60]:60s} {e.self_cpu_time_total / 1e3:10.2f} {e.count:8d}")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / f"profile_{name}{tag.replace(' ', '_')}.txt").write_text(
        ka.table(sort_by="self_device_time_total" if hasattr(ka[0], "self_device_time_total")
                 else "self_cuda_time_total", row_limit=60))
    return busy


def _profile_grad(name, plan, scene, card, top) -> int:
    from curry_pbrt_tpu_torch.interop import params_from_numpy
    from curry_pbrt_tpu_torch.parallel.mesh import backward_over_pixels, mse_pixel_loss
    from curry_pbrt_tpu_torch.render import pixel_arrays

    dev = plan.device
    target = torch.as_tensor(render_plan(plan, show_progress=False).reshape(-1, 3), device=dev)
    params = params_from_numpy(scene.init_params, dev)
    key = next(iter(params["textures"]))
    tex = torch.full_like(params["textures"][key], 0.5).requires_grad_(True)
    params["textures"][key] = tex
    po, px = pixel_arrays(plan)
    loss = mse_pixel_loss(target)

    def one_pass(times=None):
        tex.grad = None
        torch.cuda.synchronize()
        t0 = time.time()
        backward_over_pixels(plan, params, po, px, loss, times=times)
        torch.cuda.synchronize()
        return time.time() - t0

    times = {}
    torch.cuda.reset_peak_memory_stats(dev)
    wall = one_pass(times)
    print(f"[{name}] {card}: gradient pass (texture {tuple(tex.shape)}, sub-chunks of "
          f"{plan.chunk_pixels} pixels): wall {wall:.3f} s, forward {times['forward_s']:.3f} s, "
          f"backward {times['backward_s']:.3f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB", flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall = one_pass()
    _report(name, prof, wall, top, " gradient")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scene")
    ap.add_argument("--res", type=int, nargs=2, metavar=("W", "H"))
    ap.add_argument("--spp", type=int)
    ap.add_argument("--max-depth", type=int)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--passes", type=int, default=0)
    ap.add_argument("--sort-compare", action="store_true")
    ap.add_argument("--grad", action="store_true",
                    help="profile one gradient pass of the texture-recovery step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_render: needs a card (torch.cuda.is_available() is False)")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    ov = {}
    if args.res:
        ov["resolution"] = tuple(args.res)
    if args.spp:
        ov["spp"] = args.spp
    if args.max_depth is not None:
        ov["max_depth"] = args.max_depth
    name = Path(args.scene).stem
    t0 = time.time()
    scene = compile_scene_file(args.scene, overrides=ov)
    t_compile = time.time() - t0
    t0 = time.time()
    plan = plan_render(scene, device="cuda")
    torch.cuda.synchronize()
    t_plan = time.time() - t0
    (w, h), spp = scene.settings.resolution, scene.settings.spp
    print(f"[{name}] {card}: {w}x{h}, {spp} spp, depth {scene.settings.max_depth}; set-up: "
          f"compile {t_compile:.2f} s, plan {t_plan:.2f} s", flush=True)
    wall, segments, checksum = _timed(plan)  # warm-up
    print(f"[{name}] warm-up pass {wall:.3f} s, {segments} segments, checksum {checksum:.2f}",
          flush=True)

    if args.grad:
        return _profile_grad(name, plan, scene, card, args.top)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall, segments, _ = _timed(plan)
    _report(name, prof, wall, args.top, "")
    print(f"[{name}] {segments / wall:.4g} seg/s under the profiler", flush=True)

    walls = sorted(_timed(plan)[0] for _ in range(args.passes))
    if walls:
        print(f"[{name}] {len(walls)} unprofiled passes: walls {', '.join(f'{w:.3f}' for w in walls)}"
              f" s, median {walls[len(walls) // 2]:.3f} s", flush=True)
    if args.sort_compare:
        plans = {on: plan_render(scene, device="cuda", ray_sort=on) for on in (True, False)}
        for on in (True, False, False, True):
            wall, segments, checksum = _timed(plans[on])
            print(f"[{name}] ray sort {'on ' if on else 'off'}: wall {wall:.3f} s, "
                  f"{segments} segments ({segments / wall:.4g} seg/s), checksum {checksum:.2f}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
