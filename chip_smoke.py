#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (curry_pbrt_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises, so the exit code is
non-zero and no result line is printed:
  1. device  — requires CUDA; prints the card's name and power limit
               (nvidia-smi) and the torch / nvcc versions;
  2. build   — compiles csrc/*.cu with nvcc (sm_90a, -fmad=false; one nvcc
               per source, all started together) and prints the build time
               and ptxas' register report;
  3. kernels — the closest-hit (K1) and any-hit (K2) kernels, through the
               warp walk (csrc/intersect_warp.cu) and, on the cornell_tex
               tables, the small-table walk (csrc/intersect_small.cu) —
               against their plain PyTorch versions on the card:
               cornell_tex tables (block_t 8, one slab) and a 5k-triangle
               soup (block_t 64, supers, 5 slabs, a NaN padding cluster),
               32k and 1M rays with dead lanes, the render path's chunk
               shape, a batch whose t_max is each ray's exact hit t (the
               first-hit-at-t_max rule) and one with ~90% dead lanes at the
               chunk shape (each table set). Hit masks must be equal, rows
               up to exact-t ties, t bit-equal — the build's -fmad=false is
               what makes that hold; the warp walk's ms (on cornell_tex in
               turns with the small walk's), the small walk's K1b in turns
               with its K1 at the headline shape;
  3b. spheres— the sphere kernels (K3, closest and any hit) through the
               warp walk (csrc/intersect_warp.cu), the one walk the launch
               plan has for sphere tables, against their plain versions:
               the spherefield10k tables and a soup of rotated,
               anisotropically scaled spheres (supers, several slabs, a NaN
               padding cluster), 32k and 1M rays with dead lanes plus the
               sphere field's chunk shape, a t_max-tie batch on each, ~90%
               dead lanes at the chunk shape, and rays that start on a
               sphere's surface (hits at t = -0.0); masks and any-hit
               equal, t bit-equal (sign bit included), spheres equal up to
               exact-t ties; the walk's ms;
  3c. stats  — K1 with stats=True, the warp walk (and the small walk on
               cornell_tex), against the plain version's stats on the
               triangle soup, the mesh100k and the cornell_tex tables:
               per-ray (entered, improved) counts equal, (t, row)
               unchanged by stats;
  4. slice   — cornell_tex at 32², 4 spp, depth 3 through render_scene on
               the card, against tests/goldens/cornell_tex.npy under the CPU
               slice test's tolerance, and against the port's own CPU
               render (plain versions); the K1 / K2 walk of the path's
               launch plan (the small walk at block_t 8) must have launched,
               the other walks and the plain versions not, and NEE's two
               kernels (csrc/nee.cu) once a bounce of each chunk;
  5. headline— cornell_tex at 512², 64 spp, depth 5: a warm-up pass of the
               headline itself, whose first chunk's K1 / K2 inputs (11
               closest and 5 any calls, ~1.9 GB) are captured for phase 7,
               then a timed pass whose launch counts are reported; traced
               segments and the image sum against the JAX anchors
               (155,670,944 within 1e-4 relative; 86446.0 within 1e-3
               relative), and the plan's walk alone and NEE's kernels once
               a bounce, as in phase 4;
  6. configs — spheres_direct_256 (the direct-lighting integrator),
               spherefield10k_256, mesh10k_512, mesh100k_512 and
               mesh600k_256 at their full bench configs: each planned once
               (its seconds printed on their own line: set-up, not render
               time), a warm-up pass (its chunk eager, then the chunk
               program recorded), then one timed pass, a replay, with its
               wall (peak device memory over the warm-up and that pass),
               seg/s and launches; segments within 1e-4 and the image sum
               within 1e-3 relative of the JAX anchors; the sphere field
               must launch the plan's K3 walk (the warp walk), the ray sort
               must run on
               mesh100k and mesh600k, the plan's K1 / K2 walk alone (the
               warp walk on the meshes), NEE's kernels once a bounce where
               the plan takes them (ShadeContext.nee_refusal None) and
               else never, and no plain version may run on the card; spheres_direct_256 (no triangle, 4 spheres: the
               dense sphere test) must launch no traversal kernel at all;
  7. bounds  — the kernels at the paths' own shapes, on rays captured from
               the warm-up passes of phases 5 and 6 (every K1 / K2 call of
               one headline chunk: 11 closest and 5 any hit, 4,194,304 rays
               each, through the small and the warp walks — t bit-equal to
               the plain version, rows equal to its rows up to exact-t
               ties, the small K1b's stats equal to the plain stats,
               any-hit equal — by cuda_ms and device_ms in turns, and their
               per-pass sums, which say whether the plan's walk at block_t
               8 is the faster;
               every K3 launch of one sphere-field pass: 7 closest and 3 any
               hit, 262,144 rays each; a mesh10k and a mesh100k bounce 2
               with its shadow rays; each shape's live lanes printed): the
               warp walk's and the plain ms, and the least time the card
               could take (bytes or operations, from the live lanes and the
               entered-tile counts of K1's stats and of the plain versions);
               K3's per-pass sum;
  7b. nee    — NEE's two kernels (csrc/nee.cu through ops/kernels/nee.py)
               on the path's own calls: every uniform_sample_one_light call
               (one a bounce) of the chunk that holds the middle row of the
               headline and of mesh10k_512 (4,194,304 lanes each; matte and
               textured Lambert, plastic's GGX), the kernels' radiance
               bit-equal to the plain path's on every consumed lane and the
               other lanes' shadow and MIS rays at t_max 0; the whole call
               both ways in turns, the two kernels' and the walks' device
               ms, each kernel's bytes bound (nee.bound_bytes), and the
               headline's per-pass sums;
  8. probes  — the traversal-analysis path (curry_pbrt_tpu_torch/tools/):
               the group kernel K4 (closest and any hit; each ray tests only
               the clusters its own gate lets in) against its plain version
               — t bit-equal, rows equal (0 tie rows), any-hit equal, K4
               launched twice bit-equal — and against K1 / K2 (t bit-equal,
               prims up to exact-t ties, any-hit equal) on the phase-3 soup
               at 32k rays; against the plain version on a t_max-tie batch
               of that soup and on the face-tie batch (first hits at
               exactly t_max in a cluster whose box_near is t_max) and a
               coplanar batch (overlapping coplanar triangles over
               clusters: hits just below their cluster's box_near, kept by
               the gate's slack); the A/B on mesh10k and mesh100k at the
               render chunk (4,194,304 rays), depth 6, the same checks per
               bounce, K4 and K1 / K2 timed in turns by cuda_ms, K4 by
               device_ms too, the plain versions once; K4's bounds at
               mesh10k's bounces 0 and 2 — the function's (K1's / K2's
               tiles), the design's (the gate's tiles) and the group
               rule's; the roofline on cornell_tex and mesh10k; the
               granularity probe on mesh10k; the slab-grid probe P
               (csrc/slab_grid.cu) at the JAX shape and at 16,384 blocks x
               7 slabs against its plain version (rtol 1e-5; the kernel's
               bit-equality with it printed), timed by cuda_ms and
               device_ms, with a warm and a cold L2;
  9. grad    — the differentiable path on cornell_tex: (a) the triangle
               (tent) film at the headline, rendered twice — bit-equal, its
               mean within 3% of phase 5's box image; (b) gradients of the
               image sum w.r.t. the texture, every Kd and light_L at 64²,
               8 spp, depth 5 through the kernels against the brute oracle
               (rtol 1e-4, atol 1e-7); (c) BASELINE config 4 at the
               headline: phase 5's image as the target, the texture reset
               to 0.5, the gradient at that state twice (bit-equality
               reported, 1e-5 relative required), then 3 Adam steps at lr
               0.05 through parallel/mesh.make_train_step — the loss must
               fall at every step — with each step's forward and backward
               seconds, the sub-chunk size, the texel gradient checksum
               and the peak device memory; (d) d image-sum / d light_L[0,0]
               at full width against a central difference (rtol 2e-2);
               (e) the launches of (c): the plan's K1 / K2 walk alone (the
               small walk at block_t 8), no plain version on the card, the
               texel gather's backward (csrc/texel_grad.cu) 20 times a step
               (4 sub-chunks x 5 bounces) and never in a render pass;
               (f) that backward at a sub-chunk's 4,194,304 rows, 54% on one
               texel: the segment sum's, the sort's, the whole backward's
               and index_put_'s ms and the bound, the kernel within 1e-5 of
               a texel's Σ|terms| of index_put_;
  10. env + bvh — the environment light and the flat BVH: (a) the BVH
               walk of csrc/bvh_walk.cu (closest and any hit), the live-ray
               walk of the render path, launched twice (bit-equal), against
               its plain version on a soup of 5k triangles and 64 rotated,
               scaled spheres and on the sphere field's BVH: 32k rays with
               dead lanes, a batch whose t_max is each ray's hit t, an
               all-dead and an all-live batch (t bit-equal, refs equal up to
               exact-t ties, any-hit equal); its ms (CUDA events around
               back-to-back calls, and the card's time alone), the plain
               ms; (b) spherefield10k_256 and mesh10k_512 through
               intersector="bvh" against the JAX anchors of phase 6, the
               live-ray walk alone of the walks (NEE's kernels beside it;
               BVH build seconds printed as set-up), and the walk at
               mesh10k's bounce-2 shapes with its bound; (c)
               mesh10k_env_512 (tools/env_scene.py) through the warp K1 / K2
               and through the BVH walk, one eager pass each (a fresh
               plan's one pass, as render_scene's): each other's segments
               within 1e-4 and image sums within 1e-3, wall, seg/s,
               launches and peak device memory of each; (d) the scene at 128² through the
               kernels against its JAX anchor (ENV_ANCHOR);
  11. distributed — the sharded paths of parallel/ (torch.distributed)
               against the single-device ones: (a) a one-rank NCCL group in
               this process (a file store under build/dist/), the headline
               through multihost.render_distributed (its eager chunks) —
               bit-equal to phase 5's image (which phase 14 holds bit-equal
               to the replayed one), its wall beside phase 5's, the plan's
               K1 / K2 walk
               alone; (c) phase 9 (c)'s config-4 step through
               mesh.make_sharded_train_step at world size 1 from the texture
               at 0.5 — the texel gradient bit-equal to make_train_step's
               (phase 9 (c) step 1) and the same loss — then 3 steps with
               falling loss, seconds per step (forward, backward, all-reduce)
               and peak memory; (b) two rank processes sharing the card over
               gloo (NCCL refuses two ranks on one card;
               multihost.run_ranks, a time limit, a failed rank fails the
               phase): the headline through render_distributed — both images
               bit-equal to (a), each rank's wall and launches — and the
               texel gradient at 64² (the headline's spp and depth) through
               the sharded step within 1e-5 relative of the one-rank
               gradient (the all-reduce sums in another order);
  12. stages and examples — (a) tools/profile_stages.py in this process
               on the headline at N = 4,194,304 rays (3 repetitions a
               timed run): its table (wall ms, device ms, device / wall,
               launches, traversal launches per stage) with the card's
               name and power limit, and its JSON line; every stage's
               output finite; the intersect, predicate, NEE, full-bounce
               and chunk stages launched the small-walk K1 / K2 (the plan's
               walk) and no other walk, the NEE, full-bounce and chunk
               stages NEE's two kernels too, the other stages no kernel of
               the port, and no plain version ran on the card; the chunk's
               wall beside phase 5's pass wall over its 4 chunks; (b)
               `python -m curry_pbrt_tpu_torch.examples.render_from_file
               scenes/cornell_tex.pbrt --res 64 64 --spp 4` in a
               subprocess (a time limit): its PNG byte-equal to the one
               the port's cli writes for the same arguments; (c)
               tools/profile_nee.py in this process at the headline's
               shape (cornell_tex, N = 4,194,304, 3 repetitions): its table
               and JSON line, every piece's output finite, the light
               strategy, the BSDF strategy, offset+intersect and the full
               NEE launching the small-walk K1 / K2 alone, the full NEE
               NEE's two kernels too (the others no kernel of the port), no plain version on the card, and each
               piece's device ms beside (a)'s `NEE total`; (d)
               tools/probe_sphere_kernel.py at 10,000 spheres and 32,768
               rays: the dense path and K3 agree (hit masks, any hit,
               spheres up to exact-t ties), K3 launched, no plain version;
               both times and their ratio;
  13. bench  — `python -m curry_pbrt_tpu_torch.bench` in full (all 7
               configs, mesh10k_1024_full last) in a subprocess with a time
               limit: exit 0, every config present without an error, both
               gates passed (the port's stored checksums, which must cover
               every config, and the JAX anchors); each config's wall,
               seg/s, segments, checksum and its distances to the anchors,
               with the card's name and power limit, and the JSON line;
  14. graph A/B — render_plan's chunk program (render.ChunkPrograms: each
               chunk shape recorded once as a CUDA graph, then replayed)
               against its eager loop (graph=False) on the headline,
               spheres_direct_256, mesh10k_512, mesh100k_512, mesh600k_256,
               spherefield10k_256, mesh10k_512 through intersector="bvh" and
               mesh10k_env_512, each on one plan: an eager pass and two
               replayed ones (the first records) with their peak allocated
               and reserved device memory, then three turns of (eager,
               replayed), each timed to a synchronise; every pass's image
               bit-equal to the first (max |Δ| 0), its segments, launch
               counts and sorted traversals equal; the walls, the recording
               seconds (set-up), the programs and replays, and the device's
               busy time in one profiled pass each way (a profiler session
               a chunk) over the median wall; in each profiled pass, the
               port's kernels counted among the card's events, each equal
               to its wrapper's launch count (a replay's counts are the
               recording's, added once a replay: the profiler shows the
               kernels that really ran);
               the copy of spherefield10k's params (8,556 members) into the
               recorded tree timed; then phase 5's one-shot headline (a
               fresh plan's one pass) both ways, in turns (the replayed one
               pays for its recording; render_scene runs the eager one),
               each bit-equal to phase 5's image;
and then prints the per-kernel JSON line and, last, the device line. Each
phase prints its seconds.

Imports nothing of JAX. Run from the repository root's checkout.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
if not (REPO / "curry_pbrt_tpu_torch" / "csrc").is_dir():
    raise SystemExit("chip_smoke: the curry_pbrt_tpu_torch package is not beside this script")
sys.path.insert(0, str(REPO))

# The least time the card could take (the larger of bytes over the memory
# rate and operations over the f32 rate of an H100 SXM, NVIDIA's data sheet
# at the 700 W limit), shared with the roofline tool.
from curry_pbrt_tpu_torch.tools.probe_group_kernel import non_tie_mismatches, row_t  # noqa: E402
from curry_pbrt_tpu_torch.tools.roofline import (  # noqa: E402
    BOX_TEST_OPS,
    RAY_IN_BYTES,
    SPHERE_TEST_OPS,
    T_MAX_BYTES,
    TRI_TEST_OPS,
    bound,
    cuda_ms,
    device_ms,
    least_ms,
    nvidia_smi,
    table_bytes,
    turns,
)

# JAX anchors (hardware-independent: traced segments and image checksum of
# the JAX package's bench run, BENCH_r05.json)
HEADLINE = dict(res=512, spp=64, depth=5)
ANCHOR_SEGMENTS = 155_670_944
ANCHOR_CHECKSUM = 86446.0
SEG_RTOL, SUM_RTOL = 1e-4, 1e-3
# name: (scene, res, spp, depth, anchor segments, anchor checksum)
CONFIGS = {
    "spheres_direct_256": ("spheres.pbrt", 256, 16, 0, 2_418_216, 60703.7),
    "spherefield10k_256": ("spherefield10k.pbrt", 256, 4, 3, 1_243_639, 30907.0),
    "mesh10k_512": ("mesh10k.pbrt", 512, 16, 8, 11_243_977, 318225.1),
    "mesh100k_512": ("mesh100k.pbrt", 512, 16, 8, 11_251_281, 319003.6),
    "mesh600k_256": ("mesh600k.pbrt", 256, 4, 5, 703_314, 79705.3),
}
# mesh10k_env (curry_pbrt_tpu_torch/tools/env_scene.py): the config at
# mesh10k_512's size, and the JAX anchor of its 128², 16 spp, depth 8 cut —
# traced segments and image sum of the JAX package on the CPU (bvh), made by
# `JAX_PLATFORMS=cpu python -m tests.test_torch_env --anchor 128`
ENV_CONFIG = dict(res=512, spp=16, depth=8)
ENV_ANCHOR = dict(res=128, segments=702_508, checksum=27588.14393975213)
# slice tolerance: the CPU slice test's (tests/test_torch_render.py)
SLICE_RTOL = SLICE_ATOL = 1e-4
SLICE_MAX_OUTLIER_FRAC = 0.01
SLICE_SUM_RTOL = 1e-3

PROBE_DEPTH = 6  # bounces of the phase-8 workload
BENCH_TIMEOUT_S = 900  # phase 13: the port's bench, all 7 configs
# the group kernel K4's launch counters: no render path launches them
GROUP_COUNTERS = ("tri_closest_group", "tri_any_group")
# next-event estimation's two kernels (csrc/nee.cu): a launch each a bounce
# of a render pass whose plan they implement (ShadeContext.nee_refusal None)
NEE_COUNTERS = ("nee_sample", "nee_finish")

# Phase 11 (b): one of two rank processes sharing the card over gloo. The
# headline through render_distributed, then the gradient at the texture 0.5
# of the MSE against phase 11's 64² target through the sharded step.
RANK_CODE = """
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, {repo!r})
from curry_pbrt_tpu_torch.interop import params_from_numpy
from curry_pbrt_tpu_torch.ops.kernels import intersect_kernel as K
from curry_pbrt_tpu_torch.parallel.mesh import make_mesh, make_sharded_train_step
from curry_pbrt_tpu_torch.parallel.multihost import render_distributed
from curry_pbrt_tpu_torch.render import pixel_arrays, plan_render
from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file
rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
t0 = time.time()
img = render_distributed({scene!r}, {head!r}, coordinator=init, num_processes=2, process_id=rank,
                         output=out + "_head.png", device="cuda", backend="gloo")
torch.cuda.synchronize()
wall = time.time() - t0
launches = dict(K.LAUNCHES)
np.save(f"{{out}}_head_{{rank}}.npy", img)
scene = compile_scene_file({scene!r}, {small!r})
plan = plan_render(scene, device="cuda")
params = params_from_numpy(scene.init_params, "cuda")
key = next(iter(params["textures"]))
tex = params["textures"][key] = torch.full_like(params["textures"][key], 0.5).requires_grad_(True)
target = torch.as_tensor(np.load(out + "_target64.npy"), device="cuda")
step = make_sharded_train_step(plan, make_mesh(2, device="cuda"), torch.optim.SGD([tex], lr=0.0))
torch.cuda.synchronize()
t1 = time.time()
loss = float(step(params, target, *pixel_arrays(plan)))
step_wall = time.time() - t1
np.save(f"{{out}}_grad64_{{rank}}.npy", tex.grad.cpu().numpy())
torch.distributed.destroy_process_group()  # a gloo group left to the exit can abort it
print(json.dumps({{"rank": rank, "wall_s": wall, "step_s": step_wall, "loss": loss,
                  "launches": launches, "device": torch.cuda.current_device(),
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30}}))
"""


def same_bits(a, b) -> bool:
    """Two float32 arrays equal bit for bit (the sign of a zero included)."""
    import numpy as np

    a, b = (np.ascontiguousarray(x, dtype=np.float32) for x in (a, b))
    return a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))


def log(msg: str) -> None:
    print(msg, flush=True)


class Phases:
    """Prints each phase's seconds as the next one starts."""

    def __init__(self):
        self.name, self.t0 = None, time.time()

    def start(self, name=None):
        if self.name:
            log(f"[seconds] phase {self.name}: {time.time() - self.t0:.1f} s")
        self.name, self.t0 = name, time.time()


def soup_tris(n_tris: int, seed: int):
    """A random soup of n_tris small triangles in a 16-unit box."""
    import numpy as np

    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-8, 8, (n_tris, 3)).astype(np.float32)
    p1 = p0 + rng.normal(0, 0.6, (n_tris, 3)).astype(np.float32)
    p2 = p0 + rng.normal(0, 0.6, (n_tris, 3)).astype(np.float32)
    return p0, p1, p2, np.arange(n_tris, dtype=np.int32)


def soup_tables(n_tris: int, seed: int):
    import numpy as np

    from curry_pbrt_tpu_torch.ops.kernels.intersect_kernel import build_tri_tables

    return build_tri_tables(*soup_tris(n_tris, seed), block_t=64, view_origin=np.zeros(3),
                            clusters_per_slab=16, use_supers=True)


def sphere_soup_tables(n: int, seed: int):
    """Randomly rotated, anisotropically scaled spheres (as
    tests/test_sphere_kernel.py makes them), with supers, several slabs and
    a NaN padding cluster."""
    import numpy as np

    from curry_pbrt_tpu_torch.ops.kernels.sphere_kernel import build_sphere_tables

    rng = np.random.default_rng(seed)
    centers = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    radii = rng.uniform(0.1, 0.6, n).astype(np.float32)
    o2w = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        o2w[i, :3, :3] = q @ np.diag(rng.uniform(0.7, 1.4, 3))
        o2w[i, :3, 3] = centers[i]
    w2o = np.linalg.inv(o2w).astype(np.float32)
    return build_sphere_tables(w2o, o2w, radii, np.arange(n, dtype=np.int32),
                               view_origin=np.zeros(3), clusters_per_slab=16, use_supers=True)


def on_surface(n: int, seed: int, device, n_small: int = 69):
    """A unit sphere at the origin among n_small small spheres, and n rays
    that start exactly on its surface — at (±1, 0, 0), (0, ±1, 0) and
    (0, 0, ±1), in random directions, every 7th lane dead — so every live
    ray hits it at t = ±0, at -0.0 where it leaves the sphere (c = +0 over
    q < 0). → (SphereTables, (o, d, t_max))."""
    import numpy as np
    import torch

    from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX
    from curry_pbrt_tpu_torch.ops.kernels.sphere_kernel import build_sphere_tables

    rng = np.random.default_rng(seed)
    o2w = np.tile(np.eye(4, dtype=np.float32), (n_small + 1, 1, 1))
    o2w[1:, :3, 3] = rng.uniform(-3, 3, (n_small, 3))
    radius = np.concatenate([[1.0], rng.uniform(0.1, 0.3, n_small)]).astype(np.float32)
    tables = build_sphere_tables(np.linalg.inv(o2w).astype(np.float32), o2w, radius,
                                 np.arange(n_small + 1, dtype=np.int32), view_origin=np.zeros(3))
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    o = axes[rng.integers(0, 6, n)]
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full((n,), FLOAT_MAX, np.float32)
    t_max[::7] = 0.0
    return tables, tuple(torch.from_numpy(a).to(device) for a in (o, d, t_max))


def make_rays(n: int, seed: int, center, spread: float, device):
    """Rays from a box around `center` in random directions; every 7th lane
    is dead (t_max 0), the others unbounded (FLOAT_MAX) or bounded."""
    import numpy as np
    import torch

    from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX

    rng = np.random.default_rng(seed)
    o = (np.asarray(center, np.float32) + rng.uniform(-spread, spread, (n, 3))).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(rng.uniform(size=n) < 0.5, FLOAT_MAX, spread).astype(np.float32)
    t_max[::7] = 0.0
    return tuple(torch.from_numpy(a).to(device) for a in (o, d, t_max))


def sphere_row_t(tables, o, d, t_max, rows):
    """t of each ray against one given sphere row (-1 → FLOAT_MAX)."""
    import torch

    from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX
    from curry_pbrt_tpu_torch.ops.kernels.sphere_kernel import _sphere_tile_test

    t = torch.stack([_sphere_tile_test(tables.sph16[r:r + 1], o[i:i + 1], d[i:i + 1],
                                       t_max[i:i + 1])[0, 0]
                     for i, r in enumerate(rows.clamp(min=0).tolist())])
    return torch.where(rows >= 0, t, float(FLOAT_MAX))


def hold_closest(name, tables, rays, t_k, r_k, t_ref, r_ref, what):
    """K1's (t, row) against a reference's: hit masks equal, t bit-equal,
    rows equal up to exact-t ties, no hit on a dead lane. Returns the tie
    rows."""
    import torch

    o, d, t_max = rays
    hit_k, hit_r = r_k >= 0, r_ref >= 0
    if not torch.equal(hit_k, hit_r):
        raise AssertionError(f"{name}: {what} hit masks differ on "
                             f"{(hit_k != hit_r).sum().item()} rays")
    if not torch.equal(t_k, t_ref):
        bad = (t_k != t_ref)
        rel = ((t_k - t_ref).abs() / t_ref.abs().clamp(min=1e-30))[bad].max().item()
        raise AssertionError(f"{name}: {what} t not bit-equal on {bad.sum().item()} rays "
                             f"(max rel {rel:.3g})")
    diff = r_k != r_ref
    if diff.any():  # allowed only where both rows give the same t (a tie)
        tk = row_t(tables.tris16, o[diff], d[diff], t_max[diff], r_k[diff])
        tp = row_t(tables.tris16, o[diff], d[diff], t_max[diff], r_ref[diff])
        if not (torch.equal(tk, tp) and torch.equal(tk, t_k[diff])):
            raise AssertionError(f"{name}: {what} rows differ beyond exact-t ties")
    if hit_k[t_max == 0].any():
        raise AssertionError(f"{name}: a dead lane (t_max 0) reported a hit ({what})")
    return int(diff.sum())


def hold_any(name, h_k, h_ref, t_max, what):
    import torch

    if not torch.equal(h_k, h_ref):
        raise AssertionError(f"{name}: {what} differ on {(h_k != h_ref).sum().item()} rays")
    if h_k[t_max == 0].any():
        raise AssertionError(f"{name}: a dead lane (t_max 0) reported an any hit ({what})")


def hold_small(name, t_s, r_s, t_t, r_t, what):
    """Two launches of the small-table walk (K1 and K1b): each ray makes the
    same tests in the same order, so both are equal, t to the bit and rows
    exactly (no tie allowance)."""
    import torch

    if not (torch.equal(t_s.view(torch.int32), t_t.view(torch.int32)) and torch.equal(r_s, r_t)):
        raise AssertionError(f"{name}: {what}: (t, row) differ on "
                             f"{int(((t_s != t_t) | (r_s != r_t)).sum())} rays")


def check_kernels(name, tables, rays, K, plain, timing: bool, small: bool = False):
    """K1 / K2 through the warp walk (csrc/intersect_warp.cu) and, with
    small, the small-table walk (csrc/intersect_small.cu), whatever the plan
    picks for these tables, against the plain versions on one table set and
    ray batch; with timing, the warp walk's ms (with small, in turns with
    the small walk's) and the plain versions' ms."""
    import torch

    o, d, t_max = rays
    n = o.shape[0]
    kw = tables.kw
    args = (o, d, t_max, tables.tris16, tables.caabb, tables.saabb, tables.slab_aabb)
    t_w, r_w = K.tri_closest_hit_warp(*args, **kw)
    h_w = K.tri_any_hit_warp(*args, **kw)
    if small:
        t_s, r_s = K.tri_closest_hit_small(*args, **kw)
        h_s = K.tri_any_hit_small(*args, **kw)
    torch.cuda.synchronize()
    t_p, r_p = plain["closest"](*args, **kw)
    h_p = plain["any"](*args, **kw)
    ties = hold_closest(name, tables, rays, t_w, r_w, t_p, r_p, "warp K1 vs plain")
    hold_any(name, h_w, h_p, t_max, "warp K2 vs plain")
    if small:
        hold_closest(name, tables, rays, t_s, r_s, t_p, r_p, "small K1 vs plain")
        hold_any(name, h_s, h_p, t_max, "small K2 vs plain")
    hit = r_w >= 0
    walks = "warp and small walks" if small else "warp walk"
    log(f"  {name}: {n} rays ({int((t_max > 0).sum())} live), {int(hit.sum())} closest hits, "
        f"{int(h_w.sum())} any hits, {ties} tie rows — {walks}: masks equal, t bit-equal to the "
        f"plain version, rows equal up to ties, K2 equal")
    err = lambda t: (t[hit] - t_p[hit]).abs().max().item() if hit.any() else 0.0  # noqa: E731
    any_err = lambda h: (h.float() - h_p.float()).abs().max().item() if n else 0.0  # noqa: E731
    out = {"max_abs_err": err(t_w), "any_max_abs_err": any_err(h_w)}
    if small:
        out["small_max_abs_err"], out["any_small_max_abs_err"] = err(t_s), any_err(h_s)
    if timing:
        warp = (lambda: K.tri_closest_hit_warp(*args, **kw),
                lambda: K.tri_any_hit_warp(*args, **kw))
        if small:
            out["closest_ms"], out["closest_small_ms"] = turns(
                warp[0], lambda: K.tri_closest_hit_small(*args, **kw), 20)
            out["any_ms"], out["any_small_ms"] = turns(
                warp[1], lambda: K.tri_any_hit_small(*args, **kw), 20)
        else:
            out["closest_ms"], out["any_ms"] = cuda_ms(warp[0], 20), cuda_ms(warp[1], 20)
        out["closest_plain_ms"] = cuda_ms(lambda: plain["closest"](*args, **kw), 3)
        out["any_plain_ms"] = cuda_ms(lambda: plain["any"](*args, **kw), 3)
        log(f"    K1 warp {out['closest_ms']:.4f} ms (plain {out['closest_plain_ms']:.3f}); K2 "
            f"warp {out['any_ms']:.4f} ms (plain {out['any_plain_ms']:.3f})")
        if small:
            log(f"    K1 small {out['closest_small_ms']:.4f} ms, K2 small "
                f"{out['any_small_ms']:.4f} ms (in turns with the warp walk)")
    return out


def tie_batch(tables, rays, plain):
    """rays with t_max set to each hit ray's own plain-version closest t:
    the first-hit-at-t_max rule decides every such ray."""
    import torch

    o, d, t_max = rays
    t_p, _ = plain["closest"](o, d, t_max, tables.tris16, tables.caabb, tables.saabb,
                              tables.slab_aabb, **tables.kw)
    return o, d, torch.where(t_p < 1e30, t_p, t_max)


def mostly_dead(rays, seed: int, live: float = 0.1):
    """rays with all but a `live` share of the lanes dead (t_max 0)."""
    import torch

    o, d, t_max = rays
    gen = torch.Generator(device=o.device).manual_seed(seed)
    keep = torch.rand(t_max.shape, generator=gen, device=o.device) < live
    return o, d, torch.where(keep, t_max, 0.0)


def hold_sphere_closest(name, tables, rays, t_k, r_k, t_ref, r_ref, what):
    """K3's (t, row) against a reference's: hit masks equal, t bit-equal
    with its sign bit (a ray that starts on a sphere and leaves it hits at
    -0.0), spheres equal up to exact-t ties, no hit on a dead lane. Returns
    the tie spheres."""
    import torch

    o, d, t_max = rays
    hit_k, hit_r = r_k >= 0, r_ref >= 0
    if not torch.equal(hit_k, hit_r):
        raise AssertionError(f"{name}: {what} hit masks differ on "
                             f"{(hit_k != hit_r).sum().item()} rays")
    if not torch.equal(t_k.view(torch.int32), t_ref.view(torch.int32)):
        raise AssertionError(f"{name}: {what} t not bit-equal on "
                             f"{(t_k.view(torch.int32) != t_ref.view(torch.int32)).sum().item()} rays")
    diff = (r_k != r_ref) & (tables.row_sphere[r_k.clamp(min=0).long()]
                             != tables.row_sphere[r_ref.clamp(min=0).long()])
    if diff.any():  # different spheres only where both give the same t (a tie)
        tk = sphere_row_t(tables, o[diff], d[diff], t_max[diff], r_k[diff])
        tp = sphere_row_t(tables, o[diff], d[diff], t_max[diff], r_ref[diff])
        if not (torch.equal(tk, tp) and torch.equal(tk, t_k[diff])):
            raise AssertionError(f"{name}: {what} spheres differ beyond exact-t ties")
    if hit_k[t_max == 0].any():
        raise AssertionError(f"{name}: a dead lane (t_max 0) reported a sphere hit ({what})")
    return int(diff.sum())


def check_sphere_kernels(name, tables, rays, S, plain, reps=(20, 3), timed=("closest", "any")):
    """K3 (closest and any hit) through the warp walk (csrc/intersect_warp.cu)
    against the plain versions on one sphere table set and ray batch;
    returns errors, the -0.0 hits, the plain versions' entered-tile sums
    (the bound's input) and, with reps, the `timed` kernels' ms and the
    plain versions'."""
    import torch

    o, d, t_max = rays
    n = o.shape[0]
    args = (o, d, t_max, tables.sph16, tables.caabb, tables.saabb, tables.slab_aabb)
    kw = tables.kw
    t_w, r_w = S.sphere_closest_hit_warp(*args, **kw)
    h_w = S.sphere_any_hit_warp(*args, **kw)
    torch.cuda.synchronize()
    t_p, r_p, entered, _ = plain["sphere_closest"](*args, **kw, stats=True)
    h_p, any_entered = plain["sphere_any"](*args, **kw, stats=True)
    ties = hold_sphere_closest(name, tables, rays, t_w, r_w, t_p, r_p, "warp K3 vs plain")
    hold_any(name, h_w, h_p, t_max, "warp K3 any-hit vs plain")
    hit = r_w >= 0
    neg_zero = int((hit & (t_w == 0) & torch.signbit(t_w)).sum())
    log(f"  {name}: {n} rays ({int((t_max > 0).sum())} live), {int(hit.sum())} closest hits "
        f"({neg_zero} at -0.0), {int(h_w.sum())} any hits, {ties} tie spheres — warp walk: "
        f"masks equal, t bit-equal (sign included) to the plain version, spheres equal up to "
        f"ties, any-hit equal")
    err = lambda t: (t[hit] - t_p[hit]).abs().max().item() if hit.any() else 0.0  # noqa: E731
    any_err = lambda h: (h.float() - h_p.float()).abs().max().item() if n else 0.0  # noqa: E731
    out = {"max_abs_err": err(t_w), "any_max_abs_err": any_err(h_w),
           "entered": int(entered.sum()), "any_entered": int(any_entered.sum()), "n": n,
           "live": int((t_max > 0).sum()), "neg_zero": neg_zero,
           "table_bytes": table_bytes(*args[3:])}
    if reps:
        fns = {"closest": (S.sphere_closest_hit_warp, plain["sphere_closest"]),
               "any": (S.sphere_any_hit_warp, plain["sphere_any"])}
        for kind in timed:
            warp, pl = fns[kind]
            out[kind + "_ms"] = cuda_ms(lambda: warp(*args, **kw), reps[0])
            out[kind + "_plain_ms"] = cuda_ms(lambda: pl(*args, **kw), reps[1])
            log(f"    K3 {kind} warp {out[kind + '_ms']:.4f} ms (plain "
                f"{out[kind + '_plain_ms']:.3f})")
    return out


def check_stats(name, tables, rays, K, plain, reps=None, small=False):
    """K1 stats=True through the warp walk (and, with small, the small-table
    walk) vs the plain version's stats (and t bit-equal to it); returns the
    entered-tile sum and, with reps, the warp walk's times (the small
    walk's, with small) without and with stats in turns, and the plain
    ones."""
    import torch

    o, d, t_max = rays
    args = (o, d, t_max, tables.tris16, tables.caabb, tables.saabb, tables.slab_aabb)
    kw = tables.kw
    t_p, r_p, ent_p, imp_p = plain["closest"](*args, **kw, stats=True)
    hit = r_p >= 0
    err = lambda t: (t[hit] - t_p[hit]).abs().max().item() if hit.any() else 0.0  # noqa: E731
    errs = {}
    walks = [("warp", K.tri_closest_hit_warp, "")]
    if small:
        walks.append(("small", K.tri_closest_hit_small, "small_"))
    for walk, fn, sfx in walks:
        t0, r0 = fn(*args, **kw)
        t1, r1, ent_k, imp_k = fn(*args, **kw, stats=True)
        torch.cuda.synchronize()
        if not (torch.equal(t0, t1) and torch.equal(r0, r1)):
            raise AssertionError(f"{name}: stats=True changed the {walk} K1's (t, row)")
        hold_closest(name, tables, rays, t1, r1, t_p, r_p, f"{walk} K1 (stats) vs plain")
        if not (torch.equal(ent_k, ent_p) and torch.equal(imp_k, imp_p)):
            raise AssertionError(f"{name}: {walk} K1 stats differ from the plain stats on "
                                 f"{int(((ent_k != ent_p) | (imp_k != imp_p)).sum())} rays")
        errs[sfx + "max_abs_err"], errs["stats_" + sfx + "max_abs_err"] = err(t0), err(t1)
    if (imp_p > ent_p).any() or int(ent_p.max()) > tables.caabb.shape[0]:
        raise AssertionError(f"{name}: stats break improved <= entered <= n_clusters")
    out = {"entered": int(ent_p.sum()), "improved": int(imp_p.sum()), "n": o.shape[0],
           "live": int((t_max > 0).sum()), "table_bytes": table_bytes(*args[3:]),
           "block": kw["block_t"], **errs}
    log(f"  {name}: {o.shape[0]} rays ({out['live']} live), entered tiles {out['entered']} "
        f"({out['entered'] / o.shape[0]:.2f}/ray of {tables.caabb.shape[0]} clusters), "
        f"improved {out['improved']} — {', '.join(w for w, _, _ in walks)} stats equal to the "
        f"plain stats, t bit-equal, (t, row) unchanged by stats")
    if reps:
        fn = K.tri_closest_hit_small if small else K.tri_closest_hit_warp
        out["ms"], out["stats_ms"] = turns(lambda: fn(*args, **kw),
                                           lambda: fn(*args, **kw, stats=True), reps[0])
        out["plain_ms"] = cuda_ms(lambda: plain["closest"](*args, **kw), reps[1])
        out["stats_plain_ms"] = cuda_ms(lambda: plain["closest"](*args, **kw, stats=True),
                                        reps[1])
    return out


def check_any(name, tables, rays, K, plain, reps):
    """K2 through the warp walk vs the plain version on one batch (shadow
    rays); returns the plain version's entered tiles (the bound's input),
    the walk's time and the plain one's."""
    import torch

    o, d, t_max = rays
    args = (o, d, t_max, tables.tris16, tables.caabb, tables.saabb, tables.slab_aabb)
    kw = tables.kw
    h_w = K.tri_any_hit_warp(*args, **kw)
    torch.cuda.synchronize()
    h_p, entered = plain["any"](*args, **kw, stats=True)
    hold_any(name, h_w, h_p, t_max, "warp K2 vs plain")
    err = lambda h: (h.float() - h_p.float()).abs().max().item() if h.numel() else 0.0  # noqa: E731
    out = {"any_entered": int(entered.sum()), "n": o.shape[0], "live": int((t_max > 0).sum()),
           "hits": int(h_w.sum()), "table_bytes": table_bytes(*args[3:]), "block": kw["block_t"],
           "max_abs_err": err(h_w)}
    out["ms"] = cuda_ms(lambda: K.tri_any_hit_warp(*args, **kw), reps[0])
    out["plain_ms"] = cuda_ms(lambda: plain["any"](*args, **kw), reps[1])
    log(f"  {name}: {out['n']} rays ({out['live']} live), {out['hits']} any hits, "
        f"{out['any_entered']} entered tiles (plain) — warp K2 equal to the plain version")
    return out


def check_head_call(name, tables, rays, K, plain, kind, reps):
    """One K1 (kind "closest") or K2 ("any") call captured from the
    headline's pass, through the small-table walk (the plan's) and the warp
    walk: t bit-equal to the plain version's, rows equal to its rows up to
    exact-t ties, K1b's (t, row) equal to K1's and its stats equal to the
    plain stats, any-hit equal to the plain version's. Both walks' ms in
    turns, by CUDA events around back-to-back calls (cuda_ms) and by the
    card's time alone (device_ms); the plain version's ms; the bound from
    the plain version's entered tiles."""
    import torch

    o, d, t_max = rays
    n, live = o.shape[0], int((t_max > 0).sum())
    args = (o, d, t_max, tables.tris16, tables.caabb, tables.saabb, tables.slab_aabb)
    kw = tables.kw
    small, warp = ((K.tri_closest_hit_small, K.tri_closest_hit_warp) if kind == "closest"
                   else (K.tri_any_hit_small, K.tri_any_hit_warp))
    out = {"n": n, "live": live, "table_bytes": table_bytes(*args[3:]), "block": kw["block_t"]}
    if kind == "closest":
        t_s, r_s = small(*args, **kw)
        t_b, r_b, ent_s, imp_s = small(*args, **kw, stats=True)
        t_w, r_w = warp(*args, **kw)
        torch.cuda.synchronize()
        t_p, r_p, ent_p, imp_p = plain["closest"](*args, **kw, stats=True)
        hold_closest(name, tables, rays, t_s, r_s, t_p, r_p, "small K1 vs plain")
        hold_closest(name, tables, rays, t_w, r_w, t_p, r_p, "warp K1 vs plain")
        hold_small(name, t_b, r_b, t_s, r_s, "small K1b vs small K1")
        if not (torch.equal(ent_s, ent_p) and torch.equal(imp_s, imp_p)):
            raise AssertionError(f"{name}: small K1b stats differ from the plain stats")
        hit = r_s >= 0
        out["entered"], out["hits"] = int(ent_p.sum()), int(hit.sum())
        out["max_abs_err"] = (t_s[hit] - t_p[hit]).abs().max().item() if hit.any() else 0.0
        out["bound"] = bound(n, live, 8, out["table_bytes"], out["entered"], out["block"],
                             TRI_TEST_OPS)
    else:
        h_s = small(*args, **kw)
        h_w = warp(*args, **kw)
        torch.cuda.synchronize()
        h_p, ent_p = plain["any"](*args, **kw, stats=True)
        hold_any(name, h_s, h_p, t_max, "small K2 vs plain")
        hold_any(name, h_w, h_p, t_max, "warp K2 vs plain")
        out["entered"], out["hits"] = int(ent_p.sum()), int(h_s.sum())
        out["max_abs_err"] = (h_s.float() - h_p.float()).abs().max().item() if n else 0.0
        out["bound"] = bound(n, live, 1, out["table_bytes"], out["entered"], out["block"],
                             TRI_TEST_OPS)
    out["warp_ms"], out["ms"] = turns(lambda: warp(*args, **kw), lambda: small(*args, **kw), reps)
    out["warp_dev_ms"], out["dev_ms"] = turns(lambda: warp(*args, **kw),
                                              lambda: small(*args, **kw), reps, device_ms)
    out["plain_ms"] = cuda_ms(lambda: plain[kind](*args, **kw), 1)
    return out


def check_group(name, gtab, ktab, gprim, kprim, rays, G, t_any=None):
    """K4 (closest and any hit) against the plain version, and against K1 /
    K2 (ktab; None: not compared) on one ray batch: t bit-equal to the plain version's, rows equal to its rows (0
    tie rows), any-hit equal; K4 launched twice bit-equal; no hit on a dead
    lane; t bit-equal to K1's, prims equal to K1's (through each table's
    prim) up to exact-t ties, any-hit equal to K2's. t_any: the any-hit
    bound (t_max by default). Logs the plain versions' tile counts, under
    the group rule and under the gate; returns the closest-hit count."""
    import torch

    o, d, t_max = rays
    t_any = t_max if t_any is None else t_any
    kw = G.group_kw(gtab)
    c_args = (o, d, t_max, gtab.tris16, gtab.caabb, gtab.saabb, gtab.slab_aabb)
    a_args = (o, d, t_any) + c_args[3:]
    t4, r4 = G.tri_closest_hit_groups(*c_args, **kw)
    h4 = G.tri_any_hit_groups(*a_args, **kw)
    t4_2, r4_2 = G.tri_closest_hit_groups(*c_args, **kw)
    h4_2 = G.tri_any_hit_groups(*a_args, **kw)
    torch.cuda.synchronize()
    t_p, r_p, ent8, _ = G.tri_closest_hit_groups_plain(*c_args, **kw, stats=True)
    h_p, any_ent8 = G.tri_any_hit_groups_plain(*a_args, **kw, stats=True)
    _, _, ent_g, _ = G.tri_closest_hit_groups_plain(*c_args, **kw, stats=True, gate=True)
    _, any_ent_g = G.tri_any_hit_groups_plain(*a_args, **kw, stats=True, gate=True)
    bits = lambda x: x.view(torch.int32)  # noqa: E731
    for what, t, r, h in (("K4", t4, r4, h4), ("K4 relaunched", t4_2, r4_2, h4_2)):
        if not torch.equal(bits(t), bits(t_p)):
            raise AssertionError(f"{name}: {what} t not bit-equal to the plain version on "
                                 f"{int((t != t_p).sum())} rays")
        if not torch.equal(r, r_p):
            raise AssertionError(f"{name}: {what} rows differ from the plain version's on "
                                 f"{int((r != r_p).sum())} rays (0 tie rows allowed)")
        if not torch.equal(h, h_p):
            raise AssertionError(f"{name}: {what} any-hit differs from the plain version on "
                                 f"{int((h != h_p).sum())} rays")
        if (r[t_max <= 0] >= 0).any() or h[t_any <= 0].any():
            raise AssertionError(f"{name}: a dead lane (t_max 0) reported a hit ({what})")
    if not ((ent_g <= ent8).all() and (any_ent_g <= any_ent8).all()):
        raise AssertionError(f"{name}: the gate counts more tiles than the group rule")
    n_mis = "not compared"
    if ktab is not None:
        t1, r1 = ktab.closest(o, d, t_max)
        h2 = ktab.any_hit(o, d, t_any)
        if not torch.equal(t4, t1):
            raise AssertionError(f"{name}: K4 t not bit-equal to K1's on {int((t4 != t1).sum())} "
                                 f"rays")
        if not torch.equal(h4, h2):
            raise AssertionError(f"{name}: K4 any-hit differs from K2 on {int((h4 != h2).sum())} "
                                 f"rays")
        n_mis, n_bad = non_tie_mismatches(ktab, kprim, r1, gtab, gprim, r4, o, d, t_max)
        if n_bad:
            raise AssertionError(f"{name}: K4 prims differ from K1's beyond exact-t ties on "
                                 f"{n_bad} rays")
    hit = r4 >= 0
    log(f"  {name}: {o.shape[0]} rays, {int(hit.sum())} closest hits, {int(h4.sum())} any hits; "
        f"K4 and relaunched: t bit-equal to the plain version, 0 tie rows, any-hit "
        f"equal; vs K1 / K2: {n_mis} tie prims; tiles group rule {int(ent8.sum())} / any "
        f"{int(any_ent8.sum())}, gate {int(ent_g.sum())} / any {int(any_ent_g.sum())}")
    return int(hit.sum())


def bvh_soup(n_tris: int, n_sph: int, seed: int):
    """A scene-like object (.tris, .spheres, host numpy) for the BVH: the
    phase-3 triangle soup and n_sph randomly rotated, anisotropically scaled
    spheres among it."""
    import types

    import numpy as np

    from curry_pbrt_tpu_torch.ops import intersect as isect

    rng = np.random.default_rng(seed + 1000)
    o2w = np.tile(np.eye(4, dtype=np.float32), (n_sph, 1, 1))
    for i in range(n_sph):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        o2w[i, :3, :3] = q @ np.diag(rng.uniform(0.7, 1.4, 3))
        o2w[i, :3, 3] = rng.uniform(-8, 8, 3)
    sph = isect.SphereArrays(o2w, np.linalg.inv(o2w).astype(np.float32),
                             rng.uniform(0.2, 0.9, n_sph).astype(np.float32),
                             np.arange(n_sph, dtype=np.int32))
    return types.SimpleNamespace(tris=isect.TriangleArrays(*soup_tris(n_tris, seed)), spheres=sph)


def hold_bvh(name, bvh, rays, t_k, r_k, t_ref, r_ref, what):
    """The BVH walk's (t, ref) against a reference's: hit masks equal, t
    bit-equal (sign bit included), refs equal up to exact-t ties, no hit on
    a dead lane. Returns the tie refs."""
    import torch

    from curry_pbrt_tpu_torch.ops import bvh as PB
    from curry_pbrt_tpu_torch.ops.intersect import ray_shear

    o, d, t_max = rays
    hit_k, hit_r = r_k >= 0, r_ref >= 0
    if not torch.equal(hit_k, hit_r):
        raise AssertionError(f"{name}: {what} hit masks differ on "
                             f"{(hit_k != hit_r).sum().item()} rays")
    if not torch.equal(t_k.view(torch.int32), t_ref.view(torch.int32)):
        raise AssertionError(f"{name}: {what} t not bit-equal on "
                             f"{(t_k.view(torch.int32) != t_ref.view(torch.int32)).sum().item()} rays")
    diff = r_k != r_ref
    if diff.any():  # allowed only where both prims give the same t (a tie)
        sh = tuple(x[diff] for x in ray_shear(d))
        tk, _ = PB._leaf_prim_test(bvh, r_k[diff], o[diff], d[diff], sh, t_max[diff])
        tp, _ = PB._leaf_prim_test(bvh, r_ref[diff], o[diff], d[diff], sh, t_max[diff])
        if not (torch.equal(tk, tp) and torch.equal(tk, t_k[diff])):
            raise AssertionError(f"{name}: {what} refs differ beyond exact-t ties")
    if hit_k[t_max == 0].any():
        raise AssertionError(f"{name}: a dead lane (t_max 0) reported a BVH hit ({what})")
    return int(diff.sum())


def check_bvh(name, bvh, rays, reps=None):
    """The BVH walk (closest and any hit, csrc/bvh_walk.cu) against its plain
    version (ops/bvh.py's lockstep loop) on the card: the live-ray walk of
    the render path, launched twice (bit-equal: its live list's order
    varies, the results must not). t bit-equal, refs equal up to exact-t
    ties, any-hit equal. Returns the errors, the plain version's work counts
    (the bound's input) and, with reps, the walk's ms and the plain
    version's."""
    import torch

    from curry_pbrt_tpu_torch.ops import bvh as PB
    from curry_pbrt_tpu_torch.ops.kernels import bvh_kernel as BK

    o, d, t_max = rays
    n = o.shape[0]
    t_k, r_k = BK.bvh_closest(bvh, o, d, t_max)
    h_k = BK.bvh_any(bvh, o, d, t_max)
    t_k2, r_k2 = BK.bvh_closest(bvh, o, d, t_max)
    h_k2 = BK.bvh_any(bvh, o, d, t_max)
    torch.cuda.synchronize()
    if not (torch.equal(t_k.view(torch.int32), t_k2.view(torch.int32))
            and torch.equal(r_k, r_k2) and torch.equal(h_k, h_k2)):
        raise AssertionError(f"{name}: two launches of the live-ray walk differ")
    t_p, r_p, nodes, tri, sph = PB.bvh_traverse(bvh, o, d, t_max, stats=True)
    _, ra_p, a_nodes, a_tri, a_sph = PB.bvh_traverse(bvh, o, d, t_max, any_hit=True, stats=True)
    h_p = ra_p >= 0
    ties = hold_bvh(name, bvh, rays, t_k, r_k, t_p, r_p, "live-ray walk vs plain")
    hold_any(name, h_k, h_p, t_max, "live-ray any-hit walk vs plain")

    def t_err(t, r):
        hit = r >= 0
        return (t[hit] - t_p[hit]).abs().max().item() if hit.any() else 0.0

    def h_err(h):
        return (h.float() - h_p.float()).abs().max().item() if n else 0.0

    out = {"max_abs_err": t_err(t_k, r_k), "any_max_abs_err": h_err(h_k),
           "n": n, "live": int((t_max > 0).sum()), "hits": int((r_k >= 0).sum()),
           "any_hits": int(h_k.sum()), "ties": ties,
           "work": (int(nodes.sum()), int(tri.sum()), int(sph.sum())),
           "any_work": (int(a_nodes.sum()), int(a_tri.sum()), int(a_sph.sum())),
           "table_bytes": table_bytes(*bvh[:9])}
    log(f"  {name}: {n} rays ({out['live']} live), {out['hits']} closest hits, "
        f"{out['any_hits']} any hits, {ties} tie refs; plain work per live ray: "
        f"{out['work'][0] / max(out['live'], 1):.1f} nodes, "
        f"{(out['work'][1] + out['work'][2]) / max(out['live'], 1):.2f} prim tests — the "
        f"live-ray walk: t bit-equal to the plain version, refs equal up to ties, any-hit equal; "
        f"twice bit-equal")
    if reps:
        # by cuda_ms (back-to-back calls, the wrapper's host work included
        # where it outlasts the kernels), the ms of the kernels line as for
        # every kernel; and by device_ms (the card's time alone). The lane
        # pass alone (every lane dead) by device_ms
        closest = lambda: BK.bvh_closest(bvh, o, d, t_max)  # noqa: E731
        any_hit = lambda: BK.bvh_any(bvh, o, d, t_max)  # noqa: E731
        out["ms"], out["any_ms"] = cuda_ms(closest, reps[0]), cuda_ms(any_hit, reps[0])
        out["dev_ms"], out["any_dev_ms"] = device_ms(closest, reps[0]), device_ms(any_hit, reps[0])
        dead = torch.zeros_like(t_max)
        out["lane_ms"] = device_ms(lambda: BK.bvh_closest(bvh, o, d, dead), reps[0])
        out["any_lane_ms"] = device_ms(lambda: BK.bvh_any(bvh, o, d, dead), reps[0])
        out["plain_ms"] = cuda_ms(lambda: PB.bvh_traverse(bvh, o, d, t_max), reps[1])
        out["any_plain_ms"] = cuda_ms(lambda: PB.bvh_traverse(bvh, o, d, t_max, any_hit=True),
                                      reps[1])
        log(f"    cuda_ms: live-ray walk closest {out['ms']:.4f} ms (plain "
            f"{out['plain_ms']:.3f}), any {out['any_ms']:.4f} ms (plain "
            f"{out['any_plain_ms']:.3f}); device_ms: closest {out['dev_ms']:.4f}, any "
            f"{out['any_dev_ms']:.4f}; the lane pass alone (every lane dead, device_ms) "
            f"{out['lane_ms']:.4f} / {out['any_lane_ms']:.4f} ms")
    return out


def bvh_bound(st, any_hit: bool):
    """(bound ms, "bytes" or "operations") of one BVH walk: each input byte
    read once (a live ray's o, d, t_max, a dead ray's t_max, the node fields
    and the primitive rows) and each output byte written once; the
    operations the plain version counted for these rays — a slab test per
    node visited, a triangle or sphere test per leaf primitive tested."""
    nodes, tri, sph = st["any_work" if any_hit else "work"]
    n_bytes = (st["live"] * RAY_IN_BYTES + (st["n"] - st["live"]) * T_MAX_BYTES
               + st["n"] * (1 if any_hit else 8) + st["table_bytes"])
    return least_ms(n_bytes, nodes * BOX_TEST_OPS + tri * TRI_TEST_OPS + sph * SPHERE_TEST_OPS)


def leaf_params(tree, device):
    """A copy of a params tree on `device` whose tensors are leaves of
    their own (an optimizer may then update one in place)."""
    import torch

    if isinstance(tree, dict):
        return {k: leaf_params(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device).clone()


def grad_leaves(params):
    """(names, leaves): the textures, every Kd and light_L, set to
    require grad."""
    named = [(f"texture {k}", v) for k, v in params["textures"].items()]
    named += [(f"Kd of material {m}", s["Kd"]) for m, s in params["materials"].items() if "Kd" in s]
    named += [("light_L", params["light_L"])]
    for _, leaf in named:
        leaf.requires_grad_(True)
    return [n for n, _ in named], [leaf for _, leaf in named]


def nee_calls(plan, params, start: int, pixels: int):
    """The arguments of every uniform_sample_one_light call (one a bounce)
    of the plan's chunk over `pixels` pixels from `start`, by name, as the
    render path makes them (under no_grad, so through csrc/nee.cu)."""
    import inspect

    import torch

    from curry_pbrt_tpu_torch import render as R
    from curry_pbrt_tpu_torch.models import integrators as I

    calls = []
    real = I.uniform_sample_one_light
    sig = inspect.signature(real)

    def record(*args, **kw):
        calls.append(dict(sig.bind(*args, **kw).arguments))
        return real(*args, **kw)

    po, xy = R.pixel_arrays(plan)
    I.uniform_sample_one_light = record
    try:
        with torch.no_grad():
            R._render_chunk(plan, params, po[start:start + pixels], xy[start:start + pixels])
    finally:
        I.uniform_sample_one_light = real
    torch.cuda.synchronize()
    return calls


def check_nee(name, c, reps: int = 3) -> dict:
    """NEE's two kernels (ops/kernels/nee.nee) against the plain path
    (integrators.uniform_sample_one_light_plain) on one call's inputs: the
    radiance of the consumed lanes (c["mask"]) bit-equal, the other lanes'
    shadow and MIS rays at t_max 0; the whole call's ms both ways by CUDA
    events in turns (each around the same two walks); the two kernels' and
    the walks' device ms (profiler); the kernels' bytes bound
    (nee.bound_bytes)."""
    import torch

    from curry_pbrt_tpu_torch.models import integrators as I
    from curry_pbrt_tpu_torch.ops.kernels import nee as NK

    ctx, mask = c["ctx"], c["mask"]
    rays = {}
    pred, tprim = ctx.predicate, ctx.intersect_tprim

    def vis(o, d, t):
        rays["vis"] = t.clone()
        return pred(o, d, t)

    def mis(o, d, t):
        rays["mis"] = t.clone()
        return tprim(o, d, t)

    with torch.no_grad():
        ctx.predicate, ctx.intersect_tprim = vis, mis
        try:
            got = NK.nee(**c)
        finally:
            ctx.predicate, ctx.intersect_tprim = pred, tprim
        want = I.uniform_sample_one_light_plain(**c)
        diff = (got[mask].view(torch.int32) != want[mask].view(torch.int32)).any(-1)
        out = {"n": int(mask.shape[0]), "live": int(mask.sum()), "differ": int(diff.sum()),
               "max_abs_err": float((got[mask] - want[mask]).abs().max()) if mask.any() else 0.0}
        if out["differ"] or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: NEE's kernels differ from the plain path in "
                                 f"{out['differ']} of {out['live']} consumed lanes (max |Δ| "
                                 f"{out['max_abs_err']:.3g}), or give a non-finite value")
        if any(bool((rays[k][~mask] != 0).any()) for k in ("vis", "mis")):
            raise AssertionError(f"{name}: a lane whose NEE is discarded walks a ray")
        out["ms"], out["plain_ms"] = turns(lambda: NK.nee(**c),
                                           lambda: I.uniform_sample_one_light_plain(**c), reps)
        # a session can miss a record (its first kernel, now and then): each
        # NEE kernel's ms is the mean of the launches it shows, over 3 calls
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                NK.nee(**c)
            torch.cuda.synchronize()
        dev = {"nee_sample": [0.0, 0], "nee_finish": [0.0, 0], "walks": [0.0, 3],
               "other": [0.0, 3]}  # [µs, launches or calls]
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            k = port_kernel(e.key)
            key = (k[0] if k and k[0] in NEE_COUNTERS else "walks" if k else "other")
            dev[key][0] += e.device_time_total
            if key in NEE_COUNTERS:
                dev[key][1] += e.count
        if not all(dev[k][1] for k in NEE_COUNTERS):
            raise AssertionError(f"{name}: the profiler shows no launch of a NEE kernel: {dev}")
        out.update({k + "_dev_ms": us / n / 1e3 for k, (us, n) in dev.items()})
        flags = NK.nee_sample(ctx, c["params"]["light_L"], c["hit"], c["mat_ids"], c["wo"],
                              c["u"], c["fam_lobes"], mask, NK._library(),
                              torch.cuda.current_stream().cuda_stream).flags
        sample_b, finish_b = NK.bound_bytes(c["mat_ids"], c["fam_lobes"], mask, flags)
        out["sample_bytes"], out["finish_bytes"] = sample_b, finish_b
    return out


# The port's kernels (csrc/*.cu) as the profiler names them, demangled:
# "void curry::(anonymous namespace)::closest_warp_kernel<curry::TriPrim,
# true>(float const*, ...)". → (the LAUNCHES key of the wrapper that
# launches it, the kernel's part of that launch) by port_kernel.
PORT_KERNEL = re.compile(
    r"^(?:void )?(?:curry::)?(?:\(anonymous namespace\)::)?"
    r"(closest_warp_kernel|any_warp_kernel|small_kernel|walk_kernel|compact_kernel"
    r"|closest_group_kernel|any_group_kernel|slab_grid_kernel|nee_sample_kernel"
    r"|nee_finish_kernel)(<[^()]*>)?\(")


def port_kernel(name: str):
    """The profiler's name of a CUDA kernel → (LAUNCHES key, part) for a
    kernel of the port, else None. The live-ray BVH walk is two kernels a
    launch (parts "compact" and "walk"); every other wrapper launches one
    (part "")."""
    m = PORT_KERNEL.search(name)
    if m is None:
        return None
    fn, targs = m.group(1), m.group(2) or ""
    flags = re.findall(r"\b(true|false)\b", targs)
    prim = "sphere" if "SpherePrim" in targs else "tri"
    # <Prim, STATS> of the closest-hit table walks
    stats = "_stats" if flags[-1:] == ["true"] and fn.startswith("closest") else ""
    if fn in ("closest_warp_kernel", "any_warp_kernel"):
        return f"{prim}_{fn.split('_')[0]}{stats}", ""
    if fn == "small_kernel":  # <ANY, STATS>
        if flags[0] == "true":
            return "tri_any_small", ""
        return ("tri_closest_stats_small" if flags[1] == "true" else "tri_closest_small"), ""
    if fn in ("walk_kernel", "compact_kernel"):  # <ANY>
        return ("bvh_any" if flags[0] == "true" else "bvh_closest"), fn.split("_")[0]
    return {"closest_group_kernel": "tri_closest_group", "any_group_kernel": "tri_any_group",
            "slab_grid_kernel": "slab_grid", "nee_sample_kernel": "nee_sample",
            "nee_finish_kernel": "nee_finish"}[fn], ""


def launched_kernels(launches: dict) -> dict:
    """The port's kernels that launch counts stand for → {(key, part):
    instances}, as port_kernel names them."""
    want = {}
    for key, n in launches.items():
        parts = ("compact", "walk") if key in ("bvh_closest", "bvh_any") else ("",)
        want.update({(key, part): n for part in parts if n})
    return want


def graph_ab(plan, turns: int = 3) -> dict:
    """Phase 14 for one plan: render_plan through the plan's chunk program
    (graph=True) against the eager loop (graph=False). An eager pass and
    two replayed passes (the first records the programs), each after an
    emptied cache with its peak device memory; one more eager pass (the
    allocator's blocks back); then `turns` of (eager, replayed), each timed
    to a synchronise; then one profiled pass each way, each chunk in its own
    profiler session (the card's activity alone) and synchronised: the
    kernel time over the path's median wall is the device's busy share, and
    the port's kernels among the card's events must number the pass's
    launch counts. A session of one chunk keeps every record; one over a
    whole replayed headline pass (50,000 kernels) now and then lost some
    on the H100.
    → the walls, memory, busy time, those kernel counts, the program's
    recording seconds (its `record` spans) and replays, the first pass's
    image, segments and launches, and whether every pass was the first bit
    for bit, with its segments, launches and sorted traversals."""
    import numpy as np
    import torch

    from curry_pbrt_tpu_torch import render as R
    from curry_pbrt_tpu_torch.ops.kernels import intersect_kernel as K
    from curry_pbrt_tpu_torch.ops.kernels.aggregate import RAY_SORTS
    from curry_pbrt_tpu_torch.profile_render import _device_ms
    from curry_pbrt_tpu_torch.render import render_plan
    from curry_pbrt_tpu_torch.utils import trace

    dev = plan.device
    recorded_before = trace.total_s("record")

    def one(graph):
        K.reset_launches()
        RAY_SORTS["traversals"] = 0
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        img, segments = render_plan(plan, show_progress=False, count_rays=True, graph=graph)
        torch.cuda.synchronize(dev)
        return dict(wall=time.perf_counter() - t0, img=img, segments=segments,
                    launches=dict(K.LAUNCHES), sorts=RAY_SORTS["traversals"])

    def with_peak(graph, n):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        runs = [one(graph) for _ in range(n)]
        return runs, (torch.cuda.max_memory_allocated(dev) / 2**30,
                      torch.cuda.max_memory_reserved(dev) / 2**30)

    runs, eager_mem = with_peak(False, 1)
    warm, graph_mem = with_peak(True, 2)
    runs += warm + [one(False)]
    walls = {False: [], True: []}
    for _ in range(turns):
        for graph in (False, True):
            runs.append(one(graph))
            walls[graph].append(runs[-1]["wall"])
    def profiled(graph):
        """one(graph) with each chunk (the eager chunk function, or a
        program's run) inside its own profiler session → the card's kernel
        ms, device ops, port kernels and kernel names over the pass."""
        owner, attr = (R.ChunkPrograms, "run") if graph else (R, "_render_chunk")
        real = getattr(owner, attr)
        acc = dict(ms=0.0, device_ops=0, kernels={}, names=set())

        def chunk(*a, **kw):
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                out = real(*a, **kw)
                torch.cuda.synchronize(dev)
            for e in prof.key_averages():
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                acc["ms"] += _device_ms(e)
                acc["device_ops"] += e.count
                acc["names"].add(e.key)
                if port_kernel(e.key):
                    acc["kernels"][port_kernel(e.key)] = (
                        acc["kernels"].get(port_kernel(e.key), 0) + e.count)
            return out

        setattr(owner, attr, chunk)
        try:
            runs.append(one(graph))
        finally:
            setattr(owner, attr, real)
        return dict(acc, wall=runs[-1]["wall"], names=sorted(acc["names"]),
                    matched=acc["kernels"] == launched_kernels(runs[-1]["launches"]))

    busy = {graph: profiled(graph) for graph in (False, True)}
    ref = runs[0]
    equal = all(same_bits(r["img"], ref["img"]) and r["segments"] == ref["segments"]
                and r["launches"] == ref["launches"] and r["sorts"] == ref["sorts"]
                for r in runs[1:])
    median = {g: sorted(w)[len(w) // 2] for g, w in walls.items()}
    return dict(walls=walls, median=median, eager_mem=eager_mem, graph_mem=graph_mem, busy=busy,
                busy_share={g: busy[g]["ms"] / 1e3 / median[g] for g in busy},
                record_s=trace.total_s("record") - recorded_before,
                programs=sorted(plan.programs.programs),
                replays=plan.programs.replays, img=ref["img"], segments=ref["segments"],
                launches=ref["launches"], sorts=ref["sorts"], equal=equal,
                max_abs=max(float(np.abs(r["img"] - ref["img"]).max()) for r in runs[1:]))


def main() -> int:
    t_start = time.time()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — this needs a GPU")
    phases = Phases()

    # ---- 1. device
    phases.start("1 device")
    card = nvidia_smi("name,power.limit")
    log(card)  # the card's name and power limit, as nvidia-smi gives them
    from curry_pbrt_tpu_torch.ops.kernels import build

    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    log(f"[device] torch {torch.__version__} (CUDA {torch.version.cuda}), nvcc: {nvcc}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    # ---- 2. build
    phases.start("2 build")
    t0 = time.time()
    build.build(verbose=True)
    build.load_library()
    log(f"[build] nvcc {' '.join(build.NVCC_FLAGS)}: {time.time() - t0:.1f} s")

    # ---- 3. kernels against their plain versions
    phases.start("3 kernels")
    from curry_pbrt_tpu_torch.ops.kernels import aggregate as AG
    from curry_pbrt_tpu_torch.ops.kernels import intersect_kernel as K
    from curry_pbrt_tpu_torch.ops.kernels import sphere_kernel as S
    from curry_pbrt_tpu_torch.ops.kernels.aggregate import plan_tri_kernel
    from curry_pbrt_tpu_torch.render import CHUNK_RAYS
    from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file

    plain = {"closest": K.tri_closest_hit_plain, "any": K.tri_any_hit_plain,
             "sphere_closest": S.sphere_closest_hit_plain, "sphere_any": S.sphere_any_hit_plain}
    scene = compile_scene_file(REPO / "scenes" / "cornell_tex.pbrt")
    cam = np.asarray(scene.camera.camera_to_world)[:3, 3]
    ctab_host = plan_tri_kernel(scene.tris, cam)
    ctab = K.DeviceTables(ctab_host, dev)
    stab_host = soup_tables(5000, seed=1)
    stab = K.DeviceTables(stab_host, dev)
    log(f"[kernels] cornell_tex tables: {ctab_host.cluster_aabbs.shape[0]} clusters of "
        f"{ctab_host.block_t}, {ctab_host.n_slabs} slab; soup: "
        f"{stab_host.cluster_aabbs.shape[0]} clusters of {stab_host.block_t}, "
        f"{stab_host.n_slabs} slabs, supers {stab_host.use_supers}, "
        f"{int(np.isnan(stab_host.cluster_aabbs[:, 0]).sum())} NaN padding clusters")
    log(f"[kernels] launch plans: cornell_tex the {ctab.plan} walk, soup the {stab.plan} walk")
    box_c = (278.0, 274.0, 280.0)
    chunk = CHUNK_RAYS["cuda"]
    timings = {}
    for n in (1 << 15, 1 << 20, chunk):
        timings[("cornell", n)] = check_kernels(
            f"cornell_tex/{n}", ctab, make_rays(n, 10 + n % 97, box_c, 280.0, dev), K, plain,
            timing=True, small=True)
        if n < chunk:
            timings[("soup", n)] = check_kernels(
                f"soup5k/{n}", stab, make_rays(n, 20 + n % 89, (0, 0, 0), 9.0, dev), K, plain,
                timing=True)
    # t_max at each ray's exact hit t (the first-hit-at-t_max rule), and
    # ~90% dead lanes at the render chunk
    for tname, tab, c, spread in (("cornell_tex", ctab, box_c, 280.0),
                                  ("soup5k", stab, (0, 0, 0), 9.0)):
        check_kernels(f"{tname}/32768 t_max = hit t", tab,
                      tie_batch(tab, make_rays(1 << 15, 70, c, spread, dev), plain), K, plain,
                      timing=False, small=tab is ctab)
    timings[("soup 90% dead", chunk)] = check_kernels(
        f"soup5k/{chunk} 90% dead", stab, mostly_dead(make_rays(chunk, 71, (0, 0, 0), 9.0, dev), 72),
        K, plain, timing=True)
    timings[("cornell 90% dead", chunk)] = check_kernels(
        f"cornell_tex/{chunk} 90% dead", ctab,
        mostly_dead(make_rays(chunk, 73, box_c, 280.0, dev), 74), K, plain, timing=True,
        small=True)
    # the headline shape's entered tiles, for the K1/K2 bounds; the small
    # walk's K1 and K1b in turns
    head_rays = make_rays(chunk, 10 + chunk % 97, box_c, 280.0, dev)
    head_stats = check_stats(f"cornell_tex/{chunk} stats", ctab, head_rays, K, plain,
                             reps=(20, 1), small=True)
    hs = timings[("cornell", chunk)]
    log(f"[kernels] block_t 8 (SMALL_MAX_BLOCK_T {K.SMALL_MAX_BLOCK_T}; the plan: "
        f"{ctab.plan}) at the synthetic headline shape, in turns: K1 small "
        f"{hs['closest_small_ms']:.4f} ms vs warp {hs['closest_ms']:.4f}, K2 small "
        f"{hs['any_small_ms']:.4f} vs warp {hs['any_ms']:.4f}; the plan follows phase 7's sums "
        f"over the headline's own calls")
    _, head_any_entered = plain["any"](*head_rays, ctab.tris16, ctab.caabb, ctab.saabb,
                                       ctab.slab_aabb, **ctab.kw, stats=True)
    head_any_entered = int(head_any_entered.sum())

    # ---- 3b. the sphere kernels against their plain versions
    phases.start("3b spheres")
    scenes = {}  # config name → (compiled scene, compile seconds), compiled once

    def config_scene(name):
        if name not in scenes:
            fname, cres, cspp, cdepth = CONFIGS[name][:4]
            t0 = time.time()
            scenes[name] = (compile_scene_file(REPO / "scenes" / fname, overrides={
                "resolution": (cres, cres), "spp": cspp, "max_depth": cdepth}), time.time() - t0)
        return scenes[name][0]

    t0 = time.time()
    field = config_scene("spherefield10k_256")
    field_cam = np.asarray(field.camera.camera_to_world)[:3, 3]
    ftab_host = S.build_sphere_tables(field.spheres.w2o, field.spheres.o2w, field.spheres.radius,
                                      field.spheres.prim, view_origin=field_cam)
    ftab = S.DeviceSphereTables(ftab_host, dev)
    qtab_host = sphere_soup_tables(3000, seed=3)
    qtab = S.DeviceSphereTables(qtab_host, dev)
    log(f"[spheres] spherefield10k: {int((field.spheres.prim >= 0).sum())} spheres, "
        f"{ftab_host.cluster_aabbs.shape[0]} clusters of {ftab_host.block_s}, "
        f"{ftab_host.slab_aabbs.shape[0]} slab(s), supers {ftab_host.use_supers}; soup: "
        f"{qtab_host.cluster_aabbs.shape[0]} clusters, {qtab_host.slab_aabbs.shape[0]} slabs, "
        f"supers {qtab_host.use_supers}, "
        f"{int(np.isnan(qtab_host.cluster_aabbs[:, 0]).sum())} NaN padding clusters "
        f"(compile + tables {time.time() - t0:.1f} s)")
    log(f"[spheres] launch plan: spherefield10k the {ftab.plan} walk, soup the {qtab.plan} walk")
    field_res, field_spp = CONFIGS["spherefield10k_256"][1:3]
    field_chunk = field_res * field_res * field_spp
    sph_timings = {}
    for n in (1 << 15, field_chunk, 1 << 20):
        sph_timings[("field", n)] = check_sphere_kernels(
            f"spherefield10k/{n}", ftab, make_rays(n, 30 + n % 83, (0, 0, 0), 45.0, dev), S,
            plain)
        sph_timings[("soup", n)] = check_sphere_kernels(
            f"sphere soup/{n}", qtab, make_rays(n, 40 + n % 79, (0, 0, 0), 14.0, dev), S, plain)
    # t_max at each ray's exact hit t, ~90% dead lanes at the chunk shape,
    # and rays that start on a sphere's surface (hits at -0.0)
    for sname, tab, spread in (("spherefield10k", ftab, 45.0), ("sphere soup", qtab, 14.0)):
        rays = make_rays(1 << 15, 80, (0, 0, 0), spread, dev)
        t_p, _ = plain["sphere_closest"](*rays, tab.sph16, tab.caabb, tab.saabb, tab.slab_aabb,
                                         **tab.kw)
        check_sphere_kernels(f"{sname}/32768 t_max = hit t", tab,
                             (rays[0], rays[1], torch.where(t_p < 1e30, t_p, rays[2])), S, plain,
                             reps=None)
    sph_timings[("field 90% dead", field_chunk)] = check_sphere_kernels(
        f"spherefield10k/{field_chunk} 90% dead", ftab,
        mostly_dead(make_rays(field_chunk, 81, (0, 0, 0), 45.0, dev), 82), S, plain)
    otab_host, orays = on_surface(1 << 15, 83, dev)
    surf = check_sphere_kernels("on-surface/32768", S.DeviceSphereTables(otab_host, dev), orays,
                                S, plain, reps=None)
    if surf["neg_zero"] < 1000:
        raise AssertionError(f"the on-surface batch gave {surf['neg_zero']} hits at -0.0: it "
                             f"does not test the sign of t")

    # ---- 3c. K1 stats against the plain stats
    phases.start("3c stats")
    t0 = time.time()
    m100 = config_scene("mesh100k_512")
    m100_cam = np.asarray(m100.camera.camera_to_world)[:3, 3]
    mtab_host = plan_tri_kernel(m100.tris, m100_cam)
    mtab = K.DeviceTables(mtab_host, dev)
    log(f"[stats] mesh100k tables: {m100.tris.count} tris, {mtab_host.cluster_aabbs.shape[0]} "
        f"clusters of {mtab_host.block_t}, {mtab_host.n_slabs} slabs "
        f"(compile + plan {time.time() - t0:.1f} s)")
    check_stats("soup5k/1048576", stab, make_rays(1 << 20, 50, (0, 0, 0), 9.0, dev), K, plain)
    check_stats("cornell_tex/1048576", ctab, make_rays(1 << 20, 52, box_c, 280.0, dev), K, plain,
                small=True)
    check_stats("mesh100k/262144", mtab, make_rays(1 << 18, 51, (0, 0.5, 0), 3.0, dev), K, plain)

    # ---- 4. the slice at test size, on the card
    phases.start("4 slice")
    from curry_pbrt_tpu_torch.render import plan_render, render_plan, render_scene

    calls = {"plain": 0}

    def walk_counters(walk):
        """(the K1 / K2 counters of `walk`, those of the other walks)."""
        counters = {w: ("tri_closest" + x, "tri_any" + x) for w, x in K.WALK_SUFFIX.items()}
        return counters[walk], tuple(c for w, cs in counters.items() if w != walk for c in cs)

    def ran_alone(launches, walk):
        """The path's K1 / K2 walk launched, the other walk, the group
        kernel K4 and the plain versions did not run on the card."""
        need, off = walk_counters(walk)
        return min(launches[k] for k in need) > 0 and not any(launches[k] for k in off) \
            and not any(launches[k] for k in GROUP_COUNTERS) and not calls["plain"]

    def nee_ran(launches, walk, depth, engaged=True):
        """csrc/nee.cu's two kernels launched once a bounce of each chunk
        (the chunks counted by the plan's K1: 2·depth + 1 calls a chunk),
        or not at all where the plan's NEE takes the plain path."""
        chunks = launches["tri_closest" + K.WALK_SUFFIX[walk]] // (2 * depth + 1)
        want = depth * chunks if engaged else 0
        return launches["nee_sample"] == launches["nee_finish"] == want

    def forbid(fn):
        def wrapped(o, *a, **kw):
            if o.device.type == "cuda":
                calls["plain"] += 1
            return fn(o, *a, **kw)
        return wrapped

    K.tri_closest_hit_plain = forbid(plain["closest"])
    K.tri_any_hit_plain = forbid(plain["any"])
    S.sphere_closest_hit_plain = forbid(plain["sphere_closest"])
    S.sphere_any_hit_plain = forbid(plain["sphere_any"])
    small = compile_scene_file(REPO / "scenes" / "cornell_tex.pbrt",
                               overrides={"resolution": (32, 32), "spp": 4, "max_depth": 3})
    K.reset_launches()
    img, seg_small = render_scene(small, device="cuda", show_progress=False, count_rays=True)
    launches_small = dict(K.LAUNCHES)
    gold = np.load(REPO / "tests" / "goldens" / "cornell_tex.npy")
    close = np.isclose(img, gold, rtol=SLICE_RTOL, atol=SLICE_ATOL)
    frac = 1.0 - close.mean()
    sum_rel = abs(float(img.sum()) - float(gold.sum())) / float(gold.sum())
    log(f"[slice] 32² 4 spp depth 3: max |Δ| {np.abs(img - gold).max():.3g}, "
        f"{frac:.4%} of values outside rtol=atol={SLICE_RTOL}, image sum rel {sum_rel:.3g}, "
        f"{seg_small} segments, launches {launches_small}, plain calls on CUDA {calls['plain']}")
    if img.shape != gold.shape or not np.isfinite(img).all():
        raise AssertionError("slice image has the wrong shape or non-finite values")
    if frac > SLICE_MAX_OUTLIER_FRAC or sum_rel > SLICE_SUM_RTOL:
        raise AssertionError("slice render disagrees with tests/goldens/cornell_tex.npy")
    if not ran_alone(launches_small, ctab.plan):
        raise AssertionError(f"the slice did not run through the plan's K1 / K2 "
                             f"({ctab.plan} walk) alone")
    if not nee_ran(launches_small, ctab.plan, 3):
        raise AssertionError("the slice did not launch NEE's two kernels once a bounce")
    img_cpu = render_scene(small, device="cpu", show_progress=False)
    cpu_close = np.isclose(img, img_cpu, rtol=SLICE_RTOL, atol=SLICE_ATOL)
    log(f"[slice] card vs the port on the CPU (plain versions): max |Δ| "
        f"{np.abs(img - img_cpu).max():.3g}, {int((img != img_cpu).sum())} of {img.size} values "
        f"differ, {1.0 - cpu_close.mean():.4%} outside rtol=atol={SLICE_RTOL}")
    if 1.0 - cpu_close.mean() > SLICE_MAX_OUTLIER_FRAC:
        raise AssertionError("the card's slice render disagrees with the port's CPU render")

    # ---- 5. headline
    phases.start("5 headline")
    # capture: the inputs of warm-up passes' traversals for phase 7 —
    # (config, kernel, call number) → (o, d, t_max)
    captured = {}
    capture = {"calls": {}}

    def capturing(fn, key):
        def wrapped(o, d, t_max, *a, **kw):
            if torch.cuda.is_current_stream_capturing():  # a chunk program's recording
                return fn(o, d, t_max, *a, **kw)
            call = capture["calls"][key] = capture["calls"].get(key, 0) + 1
            want = capture.get(key)
            if want == "all" or (want and call in want):
                captured[(capture["config"], key, call)] = (o.clone(), d.clone(), t_max.clone())
            return fn(o, d, t_max, *a, **kw)
        return wrapped

    K.tri_closest_hit_tables = capturing(K.tri_closest_hit_tables, "tri_closest")
    K.tri_any_hit_tables = capturing(K.tri_any_hit_tables, "tri_any")
    S.sphere_closest_hit_tables = capturing(S.sphere_closest_hit_tables, "sphere_closest")
    S.sphere_any_hit_tables = capturing(S.sphere_any_hit_tables, "sphere_any")
    res, spp, depth = HEADLINE["res"], HEADLINE["spp"], HEADLINE["depth"]
    head = compile_scene_file(REPO / "scenes" / "cornell_tex.pbrt",
                              overrides={"resolution": (res, res), "spp": spp, "max_depth": depth})
    # the warm-up is the headline itself; its first chunk's K1 / K2 calls
    # (the render loop finishes a chunk before the next: 2·depth + 1 closest
    # calls, depth any-hit calls) are captured for phase 7
    head_chunk_calls = {"tri_closest": range(1, 2 * depth + 2), "tri_any": range(1, depth + 1)}
    capture.update(head_chunk_calls, config="headline", calls={})
    render_scene(head, device="cuda", show_progress=False)
    torch.cuda.synchronize()
    capture.clear()
    capture.update(config=None, calls={})
    K.reset_launches()  # counts of the main path's run start here
    t0 = time.time()
    img, segments = render_scene(head, device="cuda", show_progress=False, count_rays=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = head_launches = dict(K.LAUNCHES)
    head_wall = wall
    head_img = img
    checksum = head_checksum = float(img.astype(np.float64).sum())
    seg_rel = abs(segments - ANCHOR_SEGMENTS) / ANCHOR_SEGMENTS
    sum_rel = abs(checksum - ANCHOR_CHECKSUM) / ANCHOR_CHECKSUM
    log(f"[headline] cornell_tex {res}² {spp} spp depth {depth} on {card}: wall {wall:.3f} s, "
        f"{segments} segments ({segments / wall:.4g} seg/s), checksum {checksum:.2f}; "
        f"vs JAX anchors: segments rel {seg_rel:.3g} (≤ {SEG_RTOL}), checksum rel "
        f"{sum_rel:.3g} (≤ {SUM_RTOL}); launches {launches}, plain calls on CUDA {calls['plain']}")
    if img.shape != (res, res, 3) or not np.isfinite(img).all():
        raise AssertionError("headline image has the wrong shape or non-finite values")
    if seg_rel > SEG_RTOL or sum_rel > SUM_RTOL:
        raise AssertionError("headline disagrees with the JAX anchors")
    if not ran_alone(launches, ctab.plan):
        raise AssertionError(f"the headline did not run through the plan's K1 / K2 "
                             f"({ctab.plan} walk) alone")
    if not nee_ran(launches, ctab.plan, depth):
        raise AssertionError("the headline did not launch NEE's two kernels once a bounce")

    # ---- 6. the sphere-field and mesh configs
    phases.start("6 configs")
    # closest-hit calls per bounce: the hit, then the MIS leg's (t, prim),
    # and after the last bounce the final hit; so call 3 is bounce 1's hit
    # (2 for the any-hit shadow rays), and call 5 bounce 2's (3 for its
    # shadow rays). The sphere field: every K3 call of the pass.
    capture_at = {"spherefield10k_256": {"sphere_closest": "all", "sphere_any": "all"},
                  "mesh10k_512": {"tri_closest": {5}, "tri_any": {3}},
                  "mesh100k_512": {"tri_closest": {5}, "tri_any": {3}}}
    config_runs = {}
    for name, (fname, cres, cspp, cdepth, a_seg, a_sum) in CONFIGS.items():
        sc = config_scene(name)
        t_compile = scenes[name][1]
        t0 = time.time()
        plan = plan_render(sc, device="cuda")
        torch.cuda.synchronize()
        t_plan = time.time() - t0
        log(f"[configs] {name}: set-up, not render time: scene compile {t_compile:.2f} s, "
            f"plan (tables, shading context) {t_plan:.2f} s; {sc.tris.count} tris, "
            f"{int((np.asarray(sc.spheres.prim) >= 0).sum())} spheres, "
            f"{len(plan.ctx.families)} material families "
            f"(largest {max(len(f.members) for f in plan.ctx.families)} members)")
        capture.clear()
        capture.update(capture_at.get(name, {}), config=name, calls={})
        # the peak spans the warm-up: a replay's working set lives in the
        # programs' pool, which the allocator counts only while recording
        torch.cuda.reset_peak_memory_stats(dev)
        render_plan(plan, show_progress=False)  # warm-up: its chunk eager (captured), recorded
        torch.cuda.synchronize()
        capture.clear()
        capture.update(config=None, calls={})
        K.reset_launches()  # counts of this path's run start here
        AG.RAY_SORTS["traversals"] = 0
        t0 = time.time()
        img, segments = render_plan(plan, show_progress=False, count_rays=True)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(K.LAUNCHES)
        sorts = AG.RAY_SORTS["traversals"]
        checksum = float(img.astype(np.float64).sum())
        seg_rel = abs(segments - a_seg) / a_seg
        sum_rel = abs(checksum - a_sum) / a_sum
        config_runs[name] = dict(wall=wall, segments=segments, launches=launches, sorts=sorts,
                                 peak_gb=torch.cuda.max_memory_allocated(dev) / 2**30,
                                 checksum=checksum)
        log(f"[configs] {name} ({fname}, {cres}², {cspp} spp, depth {cdepth}) on {card}: "
            f"render wall {wall:.3f} s (plan excluded), {segments} segments "
            f"({segments / wall:.4g} seg/s), checksum {checksum:.2f}; vs JAX anchors "
            f"{a_seg} / {a_sum}: segments rel {seg_rel:.3g} (≤ {SEG_RTOL}), checksum rel "
            f"{sum_rel:.3g} (≤ {SUM_RTOL}); launches {launches}, sorted traversals {sorts}, "
            f"plain calls on CUDA {calls['plain']}")
        if img.shape != (cres, cres, 3) or not np.isfinite(img).all():
            raise AssertionError(f"{name}: image has the wrong shape or non-finite values")
        if seg_rel > SEG_RTOL or sum_rel > SUM_RTOL:
            raise AssertionError(f"{name} disagrees with the JAX anchors")
        if calls["plain"]:
            raise AssertionError(f"{name}: a plain version ran on the card")
        n_tri = int((np.asarray(sc.tris.prim) >= 0).sum())
        n_sph = int((np.asarray(sc.spheres.prim) >= 0).sum())
        if n_tri == 0 and n_sph < AG.SPHERE_KERNEL_MIN:
            # no triangle, and too few spheres for the sphere tables: no
            # traversal kernel is on this path
            if any(launches.values()):
                raise AssertionError(f"{name}: a traversal kernel launched on a scene that takes "
                                     f"the dense sphere test alone: {launches}")
            log(f"[configs] {name}: launches no traversal kernel — no triangle, and its {n_sph} "
                f"spheres (< {AG.SPHERE_KERNEL_MIN}) take the dense sphere test")
            del plan
            continue
        # the plan's walk: 8-row clusters for aggregate.plan_tri_kernel's
        # small scenes (launch_plan), as for the Cornell tables
        walk = ctab.plan if sc.tris.count <= AG.SMALL_SCENE_TRIS else "warp"
        if not ran_alone(launches, walk):
            raise AssertionError(f"{name} did not run through the {walk} walk's K1 / K2 alone")
        if not nee_ran(launches, walk, cdepth, plan.ctx.nee_refusal is None):
            raise AssertionError(f"{name}: NEE's kernels launched {launches['nee_sample']} / "
                                 f"{launches['nee_finish']} times, not once a bounce where its "
                                 f"plan takes them (refusal: {plan.ctx.nee_refusal}) and else "
                                 f"never")
        log(f"[configs] {name}: NEE {'through csrc/nee.cu' if plan.ctx.nee_refusal is None else 'on the plain path: ' + plan.ctx.nee_refusal}")
        if name.startswith("sphere") and min(launches["sphere_closest"],
                                             launches["sphere_any"]) <= 0:
            raise AssertionError(f"{name} did not run through the {ftab.plan} walk's K3: "
                                 f"{launches}")
        if name in ("mesh100k_512", "mesh600k_256") and sorts <= 0:
            raise AssertionError(f"{name}: the ray sort did not run")
        del plan

    # ---- 7. the kernels at the paths' own shapes, and their bounds
    phases.start("7 bounds")
    K.reset_launches()  # the stats kernel's path: this phase
    # every K1 / K2 call of one headline chunk, through the small-table and
    # the warp walks in turns; the per-pass sums (x the pass's chunks)
    head_calls = {}
    for kind in ("closest", "any"):
        call_nums = sorted(c for cfg, key, c in captured
                           if cfg == "headline" and key == "tri_" + kind)
        if call_nums != list(head_chunk_calls["tri_" + kind]):
            raise AssertionError(f"phase 7 holds the headline's {kind} calls {call_nums}, not "
                                 f"{list(head_chunk_calls['tri_' + kind])}")
        for call in call_nums:
            what = (f"bounce {call - 1} shadow rays" if kind == "any" else
                    {1: "bounce 0 hit: camera rays", 2 * depth + 1: "final hit"}.get(
                        call, f"bounce {(call - 1) // 2} {'MIS leg' if call % 2 == 0 else 'hit'}"))
            st = check_head_call(f"headline {kind} call {call}", ctab,
                                 captured.pop(("headline", "tri_" + kind, call)), K, plain, kind,
                                 reps=10)
            head_calls[(kind, call)] = st
            log(f"[bounds] K{1 if kind == 'closest' else 2} at the headline's {kind} call {call} "
                f"({what}; {st['n']} rays, {st['live']} live, {st['hits']} hits) on {card}: small "
                f"{st['ms']:.4f} ms (device {st['dev_ms']:.4f}), warp {st['warp_ms']:.4f} "
                f"(device {st['warp_dev_ms']:.4f}), plain {st['plain_ms']:.2f}, bound "
                f"{st['bound'][0]:.4f} ms ({st['bound'][1]}; {st['entered']} entered tiles) — "
                + ("both walks t bit-equal, rows equal up to ties, small K1b stats equal"
                   if kind == "closest" else "both walks any-hit equal"))
    n_chunks = head_launches["tri_closest" + K.WALK_SUFFIX[ctab.plan]] // (2 * depth + 1)
    head_sum = {}
    for kind in ("closest", "any"):
        sts = [st for (k, _), st in head_calls.items() if k == kind]
        head_sum[kind] = {f: n_chunks * sum(st[f] for st in sts)
                          for f in ("ms", "dev_ms", "warp_ms", "warp_dev_ms", "plain_ms")}
        head_sum[kind]["bound"] = n_chunks * sum(st["bound"][0] for st in sts)
        hsum = head_sum[kind]
        log(f"[bounds] K{1 if kind == 'closest' else 2} per headline pass ({len(sts)} calls a "
            f"chunk x {n_chunks} chunks) on {card}: small {hsum['ms']:.4f} ms (device "
            f"{hsum['dev_ms']:.4f}), warp {hsum['warp_ms']:.4f} ms (device "
            f"{hsum['warp_dev_ms']:.4f}), plain {hsum['plain_ms']:.1f} ms, bound "
            f"{hsum['bound']:.4f} ms")
    small_total = head_sum["closest"]["ms"] + head_sum["any"]["ms"]
    warp_total = head_sum["closest"]["warp_ms"] + head_sum["any"]["warp_ms"]
    faster = "small" if small_total < warp_total else "warp"
    log(f"[bounds] K1 + K2 per headline pass: small {small_total:.4f} ms, warp "
        f"{warp_total:.4f} ms — the plan's walk at block_t 8 ({ctab.plan}) "
        f"{'has the lower sum, as the plan assumes' if faster == ctab.plan else 'does NOT have the lower sum: revisit the plan'}")
    # every K3 launch of one sphere-field pass, in launch order: closest
    # calls 1 to 2·depth + 1 (bounce b's hit is call 2b + 1, its MIS leg
    # 2b + 2, the last call the final hit) and any-hit calls 1 to depth
    # (bounce b's shadow rays, b + 1)
    def k3_call(kind, call):
        if kind == "any":
            return f"bounce {call - 1} shadow rays"
        b, mis = divmod(call - 1, 2)
        return {1: "bounce 0 hit: camera rays", 2 * field_depth + 1: "final hit"}.get(
            call, f"bounce {b} {'MIS leg' if mis else 'hit'}")

    field_depth = CONFIGS["spherefield10k_256"][3]

    k3_pass = {}
    for kind, out_b, ent in (("closest", 8, "entered"), ("any", 1, "any_entered")):
        k3_calls = sorted(c for cfg, key, c in captured
                          if cfg == "spherefield10k_256" and key == "sphere_" + kind)
        if len(k3_calls) != config_runs["spherefield10k_256"]["launches"]["sphere_" + kind]:
            raise AssertionError(f"phase 7 holds {len(k3_calls)} K3 {kind} calls of the sphere "
                                 f"field's pass, which launched a different number")
        for call in k3_calls:
            what = k3_call(kind, call)
            st = check_sphere_kernels(
                f"spherefield10k {kind} call {call} ({what})", ftab,
                captured[("spherefield10k_256", "sphere_" + kind, call)], S, plain,
                reps=(10, 1), timed=(kind,))
            st["bound"] = bound(st["n"], st["live"], out_b, st["table_bytes"], st[ent],
                                ftab.kw["block_s"], SPHERE_TEST_OPS)
            k3_pass[(kind, call)] = st
            log(f"[bounds] K3 {kind} at the sphere field's call {call} ({what}; {st['n']} rays, "
                f"{st['live']} live) on {card}: warp {st[kind + '_ms']:.4f} ms (plain "
                f"{st[kind + '_plain_ms']:.3f}), bound {st['bound'][0]:.4f} ms "
                f"({st['bound'][1]}; {st[ent]} entered tiles)")
    k3_sum = {w: sum(st[k + sfx + "_ms"] for (k, _), st in k3_pass.items())
              for w, sfx in (("warp", ""), ("plain", "_plain"))}
    k3_sum["bound"] = sum(st["bound"][0] for st in k3_pass.values())
    log(f"[bounds] K3 per sphere-field pass ({len(k3_pass)} launches) on {card}: warp "
        f"{k3_sum['warp']:.4f} ms, plain {k3_sum['plain']:.2f} ms, bound "
        f"{k3_sum['bound']:.4f} ms")
    f_cl, f_any = k3_pass[("closest", 3)], k3_pass[("any", 2)]  # bounce 1
    mesh_rows, mesh_any = {}, {}
    for name in ("mesh10k_512", "mesh100k_512"):
        sc = config_scene(name)
        tab = mtab if name == "mesh100k_512" else K.DeviceTables(
            plan_tri_kernel(sc.tris, np.asarray(sc.camera.camera_to_world)[:3, 3]), dev)
        mesh_rows[name] = check_stats(f"{name} bounce 2", tab,
                                      captured[(name, "tri_closest", 5)], K, plain, reps=(5, 1))
        mesh_any[name] = check_any(f"{name} bounce-2 shadow rays", tab,
                                   captured[(name, "tri_any", 3)], K, plain, reps=(5, 1))
    stats_launches = K.LAUNCHES["tri_closest_stats"]
    stats_small_launches = K.LAUNCHES["tri_closest_stats_small"]

    # every bound counts a live ray's o, d and t_max and a dead ray's t_max
    def k1_bound(st, out_b=8):
        return bound(st["n"], st["live"], out_b, st["table_bytes"], st["entered"], st["block"],
                     TRI_TEST_OPS)

    def k2_bound(st):
        return bound(st["n"], st["live"], 1, st["table_bytes"], st["any_entered"], st["block"],
                     TRI_TEST_OPS)

    head_shape = timings[("cornell", chunk)]
    k1_b = k1_bound(head_stats)
    k2_b = k2_bound(dict(head_stats, any_entered=head_any_entered))
    k3c_b, k3a_b = f_cl["bound"], f_any["bound"]
    st100, any100 = mesh_rows["mesh100k_512"], mesh_any["mesh100k_512"]
    k1_100_b = k1_bound(st100)
    k2_100_b = k2_bound(any100)
    k1s_b = k1_bound(st100, out_b=16)
    k1s_head_b = k1_bound(head_stats, out_b=16)
    log(f"[bounds] on {card}: K1 synthetic headline shape ({chunk} rays; the plan's walk there: "
        f"{ctab.plan}): small {head_shape['closest_small_ms']:.4f} ms, warp "
        f"{head_shape['closest_ms']:.4f} ms (in turns), bound {k1_b[0]:.4f} ms ({k1_b[1]}; "
        f"{head_stats['entered']} entered tiles); K1b small {head_stats['stats_ms']:.4f} ms (K1 "
        f"in turns {head_stats['ms']:.4f}), bound {k1s_head_b[0]:.4f}; K2 small "
        f"{head_shape['any_small_ms']:.4f} ms, warp {head_shape['any_ms']:.4f} ms (in turns), "
        f"bound {k2_b[0]:.4f} ms ({k2_b[1]}; {head_any_entered} entered tiles)")
    for name, st in mesh_rows.items():
        b = k1_bound(st)
        log(f"[bounds] K1 at {name}'s bounce-2 shape ({st['n']} rays, {st['live']} live): warp "
            f"{st['ms']:.4f} ms (plain {st['plain_ms']:.3f}), bound {b[0]:.4f} ms ({b[1]}; "
            f"{st['entered']} entered tiles, {st['entered'] / st['n']:.2f}/ray); with stats warp "
            f"{st['stats_ms']:.4f} ms (plain {st['stats_plain_ms']:.3f})")
        sa = mesh_any[name]
        b = k2_bound(sa)
        log(f"[bounds] K2 at {name}'s bounce-2 shadow shape ({sa['n']} rays, {sa['live']} live): "
            f"warp {sa['ms']:.4f} ms (plain {sa['plain_ms']:.3f}), bound {b[0]:.4f} ms ({b[1]}; "
            f"{sa['any_entered']} entered tiles of the plain version)")
    for (tab, n), tm in sorted(timings.items()):
        small_ms = (f"; small K1 {tm['closest_small_ms']:.4f} / K2 {tm['any_small_ms']:.4f} ms "
                    f"(in turns with the warp walk)" if "closest_small_ms" in tm else "")
        log(f"[kernels] {tab}/{n} rays on {card}: K1 warp {tm['closest_ms']:.4f} ms (plain "
            f"{tm['closest_plain_ms']:.4f}); K2 warp {tm['any_ms']:.4f} ms (plain "
            f"{tm['any_plain_ms']:.4f}){small_ms}")
    for (tab, n), tm in sorted(sph_timings.items()):
        log(f"[spheres] {tab}/{n} rays on {card}: K3 closest warp {tm['closest_ms']:.4f} ms "
            f"(plain {tm['closest_plain_ms']:.4f}); any warp {tm['any_ms']:.4f} ms (plain "
            f"{tm['any_plain_ms']:.4f})")

    # ---- 7b. next-event estimation's kernels on the paths' own calls
    phases.start("7b nee")
    from curry_pbrt_tpu_torch.interop import params_from_numpy

    nee_runs = {}  # scene → [check_nee of each bounce] of the chunk that holds the middle row
    for name, sc in (("headline", head), ("mesh10k_512", config_scene("mesh10k_512"))):
        plan = plan_render(sc, device="cuda")
        if plan.ctx.nee_refusal is not None:
            raise AssertionError(f"{name}: NEE's kernels do not take its plan: "
                                 f"{plan.ctx.nee_refusal}")
        C, n_pix = plan.chunk_pixels, sc.settings.resolution[0] * sc.settings.resolution[1]
        start = (n_pix // 2) // C * C
        calls_nee = nee_calls(plan, params_from_numpy(sc.init_params, dev), start, C)
        if len(calls_nee) != sc.settings.max_depth:
            raise AssertionError(f"{name}: {len(calls_nee)} NEE calls in a chunk, not "
                                 f"{sc.settings.max_depth}")
        nee_runs[name] = []
        for bounce, c in enumerate(calls_nee):
            st = check_nee(f"{name} NEE bounce {bounce}", c)
            st["bound"] = (least_ms(st["sample_bytes"], 0)[0], least_ms(st["finish_bytes"], 0)[0])
            nee_runs[name].append(st)
            log(f"[nee] {name} bounce {bounce} (chunk from pixel {start}; {st['n']} lanes, "
                f"{st['live']} consumed) on {card}: kernels bit-equal to the plain path on every "
                f"consumed lane, discarded lanes' rays at t_max 0; the call (walks included) "
                f"{st['ms']:.4f} ms vs plain {st['plain_ms']:.4f} ms; device: nee_sample "
                f"{st['nee_sample_dev_ms']:.4f} ms (bound {st['bound'][0]:.4f}, "
                f"{st['sample_bytes']} B), nee_finish {st['nee_finish_dev_ms']:.4f} ms (bound "
                f"{st['bound'][1]:.4f}, {st['finish_bytes']} B), walks "
                f"{st['walks_dev_ms']:.4f} ms, other ops {st['other_dev_ms']:.4f} ms")
        del calls_nee, plan
    torch.cuda.empty_cache()
    head_nee = {f: n_chunks * sum(st[f] for st in nee_runs["headline"])
                for f in ("ms", "plain_ms", "nee_sample_dev_ms", "nee_finish_dev_ms",
                          "walks_dev_ms", "other_dev_ms")}
    head_nee["bound"] = tuple(n_chunks * sum(st["bound"][j] for st in nee_runs["headline"])
                              for j in (0, 1))
    log(f"[nee] per headline pass ({depth} calls a chunk x {n_chunks} chunks, each chunk as "
        f"the middle one) on {card}: the calls {head_nee['ms']:.3f} ms vs plain "
        f"{head_nee['plain_ms']:.3f} ms; device nee_sample {head_nee['nee_sample_dev_ms']:.3f} "
        f"ms (bound {head_nee['bound'][0]:.4f}), nee_finish "
        f"{head_nee['nee_finish_dev_ms']:.3f} ms (bound {head_nee['bound'][1]:.4f}), walks "
        f"{head_nee['walks_dev_ms']:.3f} ms, other ops {head_nee['other_dev_ms']:.3f} ms")

    # ---- 8. the traversal-analysis path: K4, the A/B, the roofline, the
    # granularity probe, P
    phases.start("8 probes")
    from curry_pbrt_tpu_torch.ops.kernels import intersect_group as G
    from curry_pbrt_tpu_torch.tools import probe_granularity as PG
    from curry_pbrt_tpu_torch.tools import probe_group_kernel as PK
    from curry_pbrt_tpu_torch.tools import probe_slab_grid as PS
    from curry_pbrt_tpu_torch.tools import roofline as RL
    from curry_pbrt_tpu_torch.tools.workload import Workload

    gsoup_host = G.group_tables(*soup_tris(5000, seed=1), view_origin=np.zeros(3),
                                clusters_per_slab=16)
    gsoup = K.DeviceTables(gsoup_host, dev)
    log(f"[probes] K4 soup tables: {gsoup_host.cluster_aabbs.shape[0]} clusters of "
        f"{gsoup_host.block_t}, {gsoup_host.n_slabs} slabs, supers {gsoup_host.use_supers}, "
        f"{int(np.isnan(gsoup_host.cluster_aabbs[:, 0]).sum())} NaN padding clusters")
    as_t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    check_group("soup5k/32768", gsoup, stab, as_t(gsoup_host.prim), as_t(stab_host.prim),
                make_rays(1 << 15, 60, (0, 0, 0), 9.0, dev), G)
    # t_max at each ray's own closest t; and the face-tie batch: first hits
    # at exactly t_max in a cluster whose box_near is t_max (K1's per-ray
    # walk, on any tables, and a strict gate lose them; the group rule keeps
    # them), on K4's own tables
    o_t, d_t, tm_t = make_rays(1 << 15, 61, (0, 0, 0), 9.0, dev)
    t_tie, _ = G.tri_closest_hit_groups_plain(o_t, d_t, tm_t, gsoup.tris16, gsoup.caabb,
                                              gsoup.saabb, gsoup.slab_aabb, **G.group_kw(gsoup))
    check_group("soup5k/32768 t_max = hit t", gsoup, None, None, None,
                (o_t, d_t, torch.where(t_tie < 1e30, t_tie, tm_t)), G)
    ftab_host, face_rays, face_tie = PK.face_tie_batch(n_rays=1 << 15)
    ftab = K.DeviceTables(ftab_host, dev)
    f_hits = check_group("face-tie/32768", ftab, None, None, None,
                         tuple(torch.from_numpy(a).to(dev) for a in face_rays), G)
    f_t, _ = G.tri_closest_hit_groups(*(torch.from_numpy(a).to(dev) for a in face_rays),
                                      ftab.tris16, ftab.caabb, ftab.saabb, ftab.slab_aabb,
                                      **G.group_kw(ftab))
    if not bool((f_t[torch.as_tensor(face_tie, device=dev)] == 4.0).all()):
        raise AssertionError("face-tie: K4 lost a first hit at exactly t_max")
    log(f"[probes] face-tie: {len(face_tie)} rays whose first hit is at exactly t_max = 4.0 in a "
        f"cluster whose box_near is 4.0: K4 keeps each ({f_hits} closest hits)")
    # coplanar triangles split over clusters: hits that fall below their
    # cluster's box_near, which the gate's slack keeps (K1 may lose them)
    ctab_host, co_rays = PK.coplanar_batch(n_quads=3000, n_rays=1 << 15, seed=3)
    check_group("coplanar/32768", K.DeviceTables(ctab_host, dev), None, None, None,
                tuple(torch.from_numpy(a).to(dev) for a in co_rays), G)

    K.reset_launches()  # the probe path's counts start here
    ab = {}
    for name in ("mesh10k_512", "mesh100k_512"):
        wl = Workload(config_scene(name), dev, tables=mtab if name == "mesh100k_512" else None)
        ab[name] = PK.analyze(name, chunk, PROBE_DEPTH, "cuda", wl=wl,
                              stats_at=(0, 2) if name == "mesh10k_512" else ())
    ab_launches = dict(K.LAUNCHES)
    for s_ab in ab.values():
        log(f"[probes] K4 / K1 (warp walk) A/B on {card}:\n" + PK.report(s_ab))
        PK.check(s_ab)
    log(f"[probes] A/B launches: {ab_launches}")
    if min(ab_launches[k] for k in GROUP_COUNTERS + ("tri_closest", "tri_any")) <= 0:
        raise AssertionError("the probe path did not launch K4 and K1 / K2")

    # K4's bounds at mesh10k's bounces 0 and 2: the function's (K1's / K2's
    # per-ray entered tiles of 64 rows on the same rays: the least work),
    # the design's (the gate's tiles of 128 rows: the kernel's own work) and
    # the group rule's (every ray of a visited cluster's group)
    peak = RL.card_peak(dev)
    s10 = ab["mesh10k_512"]
    pair = s10["pair"]
    k4_bytes = table_bytes(pair.k4.tris16, pair.k4.caabb, pair.k4.saabb, pair.k4.slab_aabb)
    blk1, blk4 = pair.k1.kw["block_t"], pair.kw4["block_t"]
    k4_bounds = {}
    for r in (s10["bounces"][0], s10["bounces"][2]):
        n, live, a_live = s10["rays"], r["active"], r["any_live"]
        b_fn = bound(n, live, 8, k4_bytes, r["k1_tiles"], blk1, TRI_TEST_OPS)
        b_gate = bound(n, live, 8, k4_bytes, r["gate_tiles"], blk4, TRI_TEST_OPS)
        b_grp = bound(n, live, 8, k4_bytes, r["group_tiles"], blk4, TRI_TEST_OPS)
        a_fn = bound(n, a_live, 1, k4_bytes, r["k2_tiles"], blk1, TRI_TEST_OPS)
        a_gate = bound(n, a_live, 1, k4_bytes, r["gate_any_tiles"], blk4, TRI_TEST_OPS)
        a_grp = bound(n, a_live, 1, k4_bytes, r["group_any_tiles"], blk4, TRI_TEST_OPS)
        share = lambda tiles, ms: 100.0 * RL.tile_ops(tiles, blk4) / (ms * 1e-3) / peak["ops_per_s"]  # noqa: E731
        k4_bounds[r["bounce"]] = (b_fn, a_fn)
        log(f"[bounds] K4 at mesh10k's bounce-{r['bounce']} shape ({n} rays, {live} live) on "
            f"{card}: closest {r['k4_ms']:.4f} ms, device {r['k4_dev_ms']:.4f} (K1 "
            f"{r['k1_ms']:.4f}; plain {r['plain_ms']:.1f}); function bound {b_fn[0]:.4f} ms "
            f"({b_fn[1]}; K1's {r['k1_tiles']} tiles of {blk1}), design bound {b_gate[0]:.4f} ms "
            f"({b_gate[1]}; the gate's {r['gate_tiles']} tiles of {blk4}), group rule "
            f"{r['group_tiles']} tiles of {blk4} ({b_grp[0]:.4f} ms); the gate's tiles at "
            f"{share(r['gate_tiles'], r['k4_ms']):.1f}% of the derived peak. Any "
            f"{r['k4_any_ms']:.4f} ms, device {r['k4_any_dev_ms']:.4f} (K2 {r['k2_ms']:.4f}; "
            f"plain {r['any_plain_ms']:.1f}); "
            f"function bound {a_fn[0]:.4f} ms ({a_fn[1]}; K2's {r['k2_tiles']} tiles of {blk1}), "
            f"design bound {a_gate[0]:.4f} ms ({a_gate[1]}; the gate's {r['gate_any_tiles']}), "
            f"group rule {r['group_any_tiles']} ({a_grp[0]:.4f} ms)")
    r2 = s10["bounces"][2]
    k4c_b, k4a_b = k4_bounds[2]

    log(f"[roofline] {card}: peak {peak['derivation']}")
    for name, sc in (("cornell_tex", scene), ("mesh10k_512", config_scene("mesh10k_512"))):
        log(RL.report(RL.analyze(name, chunk, PROBE_DEPTH, "cuda", peak=peak,
                                 wl=Workload(sc, dev))))
    gran = PG.analyze("mesh10k_512", chunk, PROBE_DEPTH, "cuda",
                      wl=Workload(config_scene("mesh10k_512"), dev))
    log(f"[granularity] {card}:\n" + PG.report(gran))

    K.reset_launches()  # P's path: the probe at both shapes
    p_small = PS.run(2, 3, "cuda")
    p_big = PS.run(16384, 7, "cuda")
    p_launches = K.LAUNCHES["slab_grid"]
    if p_launches != 2:
        raise AssertionError(f"the P probe launched its kernel {p_launches} times, not 2")
    p_in = PS.make_inputs(16384, 7, device=dev)
    p_bits = torch.equal(PS.slab_grid(*p_in), PS.slab_grid_plain(*p_in))
    p_ms = cuda_ms(lambda: PS.slab_grid(*p_in), 50)
    p_dev = device_ms(lambda: PS.slab_grid(*p_in), 50)
    p_plain_ms = cuda_ms(lambda: PS.slab_grid_plain(*p_in), 5)
    # back to back, the 33.5 MB that P reads and writes stay in the 50 MB L2;
    # cold: each launch after a 256 MB fill that evicts them, less the fill
    p_flush = torch.empty(1 << 26, dtype=torch.float32, device=dev)

    def after_flush(fn):
        def run():
            p_flush.fill_(0.0)
            fn()
        return run

    fill_ms = device_ms(lambda: p_flush.fill_(0.0), 50)
    p_cold = device_ms(after_flush(lambda: PS.slab_grid(*p_in)), 50)
    fill_ms = (fill_ms + device_ms(lambda: p_flush.fill_(0.0), 50)) / 2
    p_cold -= fill_ms
    del p_flush
    p_n, p_s = p_in[1].shape[1], 7
    # row 0 of the rays in, the output out, the slabs and one table entry
    # per slab; 65 operations per slab sum, 2 per (ray, slab)
    p_b = least_ms(p_n * 8 + p_s * (8 * 8 + 1) * 4, p_s * 65 + p_n * p_s * 2)
    log(f"[P] {card}: 2 blocks x 3 slabs max |d| {p_small[1]:.3g} (rel {p_small[2]:.3g}), "
        f"16384 blocks x 7 slabs max |d| {p_big[1]:.3g} (rel {p_big[2]:.3g}) vs plain (rtol "
        f"{PS.RTOL}), bit-equal to plain at 16384 x 7: {p_bits}; {p_ms:.4f} ms, device "
        f"{p_dev:.4f}, device with a cold L2 {p_cold:.4f} (the 256 MB fill {fill_ms:.4f}); plain "
        f"{p_plain_ms:.4f}; bound {p_b[0]:.4f} ms ({p_b[1]}); launches {p_launches}")

    # ---- 9. the differentiable path
    phases.start("9 grad")
    from curry_pbrt_tpu_torch.parallel.mesh import (
        backward_over_pixels,
        make_train_step,
        mse_pixel_loss,
    )
    from curry_pbrt_tpu_torch.render import _render_chunk, pixel_arrays

    # (a) the tent film at the headline, twice: bit-equal, mean near the box
    tri = compile_scene_file(REPO / "scenes" / "cornell_tex.pbrt", overrides={
        "resolution": (res, res), "spp": spp, "max_depth": depth, "filter": "triangle"})
    tri_plan = plan_render(tri, device="cuda")
    tri_imgs, tri_walls = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        tri_imgs.append(render_plan(tri_plan, show_progress=False))
        torch.cuda.synchronize()
        tri_walls.append(time.time() - t0)
    tri_equal = np.array_equal(tri_imgs[0], tri_imgs[1])
    mean_rel = abs(float(tri_imgs[0].mean()) - float(head_img.mean())) / float(head_img.mean())
    tri_box = float(np.abs(tri_imgs[0] - head_img).max())
    log(f"[grad] (a) triangle filter, cornell_tex {res}² {spp} spp depth {depth} on {card}: walls "
        f"{tri_walls[0]:.3f} / {tri_walls[1]:.3f} s, two renders bit-equal: {tri_equal}; mean "
        f"{float(tri_imgs[0].mean()):.6f} vs the box film's {float(head_img.mean()):.6f} (rel "
        f"{mean_rel:.3g}, ≤ 0.03), max |tent − box| {tri_box:.3g}")
    if tri_imgs[0].shape != (res, res, 3) or not np.isfinite(tri_imgs[0]).all():
        raise AssertionError("the triangle-filter image has the wrong shape or non-finite values")
    if not tri_equal:
        raise AssertionError("the two triangle-filter renders are not bit-equal")
    if mean_rel > 0.03 or tri_box <= 1e-4:
        raise AssertionError("the triangle-filter image is not a tent-filtered box image")

    # (b) parameter gradients through the kernels against the brute oracle
    small_g = compile_scene_file(REPO / "scenes" / "cornell_tex.pbrt", overrides={
        "resolution": (64, 64), "spp": 8, "max_depth": depth})
    grads_by = {}
    for backend in ("brute", "kernel"):
        gplan = plan_render(small_g, device="cuda", intersector=backend)
        gparams = leaf_params(small_g.init_params, dev)
        names, leaves = grad_leaves(gparams)
        img_g = _render_chunk(gplan, gparams, *pixel_arrays(gplan))[0]
        grads_by[backend] = torch.autograd.grad(img_g.sum(), leaves)
    for gname, a, b in zip(names, grads_by["brute"], grads_by["kernel"]):
        rel = float(((a - b).abs() / a.abs().clamp(min=1e-30)).max())
        log(f"[grad] (b) d sum(image) / d {gname} {tuple(a.shape)} at 64² 8 spp depth {depth}: "
            f"kernel vs brute max |Δ| {float((a - b).abs().max()):.3g} (max rel {rel:.3g}), "
            f"|grad| sum {float(a.abs().sum()):.6g}")
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"(b) a gradient w.r.t. {gname} is not finite")
        if not torch.allclose(b, a, rtol=1e-4, atol=1e-7) or float(a.abs().sum()) == 0.0:
            raise AssertionError(f"(b) kernel and brute gradients w.r.t. {gname} disagree "
                                 f"(rtol 1e-4, atol 1e-7) or vanish")

    # (c) the BASELINE config-4 step at full width: recover the texture
    plan_h = plan_render(head, device="cuda")
    po_h, px_h = pixel_arrays(plan_h)
    target = torch.as_tensor(head_img.reshape(-1, 3), device=dev)  # from init_params
    params_h = leaf_params(head.init_params, dev)
    tex_key = next(iter(params_h["textures"]))
    tex = params_h["textures"][tex_key]
    with torch.no_grad():
        tex.fill_(0.5)
    tex.requires_grad_(True)
    mse = mse_pixel_loss(target)
    K.reset_launches()  # (e): the launches of (c) start here
    plain_before = calls["plain"]
    torch.cuda.reset_peak_memory_stats(dev)
    det = []
    for _ in range(2):  # the gradient at one state, twice
        tex.grad = None
        times = {}
        loss0 = backward_over_pixels(plan_h, params_h, po_h, px_h, mse, times=times)
        det.append((tex.grad.clone(), float(loss0), times))
    pass_launches = {k: v // 2 for k, v in K.LAUNCHES.items()}
    g_bits = torch.equal(det[0][0], det[1][0])
    g_rel = float((det[0][0] - det[1][0]).abs().max() / det[0][0].abs().max())
    step = make_train_step(plan_h, torch.optim.Adam([tex], lr=0.05))
    losses, step_stats, step_tg = [], [], []
    for k in range(3):
        times = {}
        tg0 = K.LAUNCHES["texel_grad"]
        torch.cuda.synchronize()
        t0 = time.time()
        losses.append(float(step(params_h, target, po_h, px_h, times=times)))
        step_stats.append((time.time() - t0, times, float(tex.grad.abs().sum())))
        step_tg.append(K.LAUNCHES["texel_grad"] - tg0)
        if k == 0:  # make_train_step's gradient at the texture 0.5, for phase 11 (c)
            step1_grad = tex.grad.clone()
    tg0 = K.LAUNCHES["texel_grad"]
    with torch.no_grad():
        img_3 = torch.as_tensor(render_plan(plan_h, params_h, show_progress=False).reshape(-1, 3),
                                device=dev)
        losses.append(float(mse(img_3, slice(None))))
    render_tg = K.LAUNCHES["texel_grad"] - tg0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    launches_c = dict(K.LAUNCHES)
    log(f"[grad] (c) config-4 step, cornell_tex {res}² {spp} spp depth {depth}, the texture "
        f"{tuple(tex.shape)} from 0.5, Adam lr 0.05, sub-chunks of {plan_h.chunk_pixels} pixels "
        f"({plan_h.chunk_pixels * spp} rays; {-(-res * res // plan_h.chunk_pixels)} a pass) on "
        f"{card}: peak device memory {peak_gb:.2f} GiB")
    for k, (wall, times, gsum) in enumerate(step_stats):
        log(f"[grad] (c) step {k + 1}: loss before {losses[k]:.6g}, wall {wall:.3f} s (forward "
            f"{times['forward_s']:.3f} s, backward {times['backward_s']:.3f} s), texel "
            f"gradient checksum Σ|grad| {gsum:.6g}")
    log(f"[grad] (c) loss after step 3 {losses[3]:.6g}; losses {losses}")
    log(f"[grad] (c) the gradient at one state twice: bit-equal {g_bits}, max rel diff "
        f"{g_rel:.3g} (≤ 1e-5); checksums {float(det[0][0].abs().sum()):.6g} / "
        f"{float(det[1][0].abs().sum()):.6g}; forward {det[0][2]['forward_s']:.3f} / "
        f"{det[1][2]['forward_s']:.3f} s, backward {det[0][2]['backward_s']:.3f} / "
        f"{det[1][2]['backward_s']:.3f} s")
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"(c) the loss did not fall at every step: {losses}")
    if g_rel > 1e-5 or not torch.isfinite(det[0][0]).all():
        raise AssertionError(f"(c) two gradients at one state differ by {g_rel:.3g} (> 1e-5)")

    # (e) the launches of (c): the plan's K1 / K2 walk alone, no plain version;
    # the texel gather's backward once a sub-chunk and bounce, never in a
    # render pass
    log(f"[grad] (e) launches during (c) (2 gradient passes, 3 steps, 1 forward): {launches_c}; "
        f"per gradient pass {pass_launches}; plain calls on CUDA {calls['plain'] - plain_before}")
    n_sub = -(-res * res // plan_h.chunk_pixels)
    log(f"[grad] (e) texel_grad launches a step {step_tg} ({n_sub} sub-chunks x {depth} bounces "
        f"= {n_sub * depth}); in the render pass after them {render_tg}")
    if calls["plain"] != plain_before or not ran_alone(launches_c, ctab.plan):
        raise AssertionError(f"(c) did not run through the plan's K1 / K2 ({ctab.plan} walk) "
                             f"alone")
    if step_tg != [n_sub * depth] * 3 or n_sub * depth != 20 or render_tg:
        raise AssertionError(f"(e) a config-4 step launched texel_grad {step_tg} times (not "
                             f"20), or a render pass launched it {render_tg} times")

    # (f) the texel gather's backward at a step's shape: a sub-chunk's
    # 4,194,304 rows into the 128² texture, 54% of them on the (0, 0)
    # texel (the most of a bounce); the segment sum alone on the sorted ids,
    # the sort, the whole backward and the plain version (index_put_)
    from curry_pbrt_tpu_torch.ops.kernels import texel_grad as TG
    from curry_pbrt_tpu_torch.ops.kernels.build import load_library

    n_rows, n_tex = plan_h.chunk_pixels * spp, tex.shape[0] * tex.shape[1]
    hot = (tex.shape[0] - 1) * tex.shape[1]  # the texel uv = (0, 0) maps to
    gen = torch.Generator(device=dev).manual_seed(18)
    tg_ids = torch.randint(0, n_tex, (n_rows,), generator=gen, device=dev, dtype=torch.int32)
    tg_ids[torch.rand((n_rows,), generator=gen, device=dev) < 0.54] = hot
    tg_grad = torch.randn((n_rows, 3), generator=gen, device=dev)
    tg_sorted, tg_perm = torch.sort(tg_ids, stable=True)
    tg_rows = load_library().curry_texel_grad_carry_rows(n_rows)
    tg_out = torch.zeros((n_tex, 3), device=dev)
    tg_cids = torch.empty((tg_rows,), dtype=torch.int32, device=dev)
    tg_cvals = torch.empty((tg_rows, 3), device=dev)

    def segment_sum():
        err = load_library().curry_texel_grad(
            tg_sorted.data_ptr(), tg_perm.data_ptr(), tg_grad.data_ptr(), n_rows, n_tex,
            tg_out.data_ptr(), tg_cids.data_ptr(), tg_cvals.data_ptr(), tg_rows,
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"curry_texel_grad failed: CUDA error {err}")

    tg_k = {"kernel": cuda_ms(segment_sum, 50), "kernel_dev": device_ms(segment_sum, 50),
            "sort": cuda_ms(lambda: torch.sort(tg_ids, stable=True), 20),
            "whole": cuda_ms(lambda: TG.texel_grad(tg_ids, tg_grad, n_tex), 20)}
    tg_plain_ms = cuda_ms(lambda: TG.texel_grad_plain(tg_ids, tg_grad, n_tex), 3)
    tg_a = TG.texel_grad(tg_ids, tg_grad, n_tex)
    tg_d = (tg_a - TG.texel_grad_plain(tg_ids, tg_grad, n_tex)).abs()
    tg_err = float(tg_d.max())  # a reassociation of float32 sums: against Σ|terms| a texel
    tg_mag = TG.texel_grad_plain(tg_ids, tg_grad.abs(), n_tex)
    tg_rel = float((tg_d / tg_mag.clamp(min=1e-30)).max())
    tg_b = least_ms(24 * n_rows + 12 * n_tex, 3 * n_rows)
    log(f"[grad] (f) texel_grad at {n_rows} rows into {n_tex} texels, "
        f"{float((tg_ids == hot).float().mean()):.3f} of them on one, on {card}: segment sum "
        f"{tg_k['kernel']:.4f} ms (device {tg_k['kernel_dev']:.4f}), sort {tg_k['sort']:.4f} "
        f"ms, whole backward {tg_k['whole']:.4f} ms, plain (index_put_) {tg_plain_ms:.2f} ms, "
        f"bound {tg_b[0]:.4f} ms ({tg_b[1]}; 24 B a row); max |kernel - plain| {tg_err:.3g}, "
        f"{tg_rel:.3g} of the texel's Σ|terms| (≤ 1e-5)")
    if not tg_rel <= 1e-5:
        raise AssertionError("(f) the segment sum and index_put_ differ by more than a "
                             "reassociation of float32 sums")
    del tg_ids, tg_grad, tg_sorted, tg_perm, tg_out, tg_cids, tg_cvals, tg_a, tg_d, tg_mag

    # (d) a central finite difference of light_L[0, 0] at full width
    params_d = leaf_params(head.init_params, dev)
    light_L = params_d["light_L"].requires_grad_(True)
    backward_over_pixels(plan_h, params_d, po_h, px_h, lambda img_s, sl: img_s.sum())
    g00, eps = float(light_L.grad[0, 0]), 1e-2

    def image_sum(delta):
        bumped = light_L.detach().clone()
        bumped[0, 0] += delta
        img_d = render_plan(plan_h, dict(params_d, light_L=bumped), show_progress=False)
        return float(img_d.astype(np.float64).sum())

    fd = (image_sum(eps) - image_sum(-eps)) / (2 * eps)
    fd_rel = abs(g00 - fd) / abs(fd)
    log(f"[grad] (d) d sum(image) / d light_L[0, 0] at full width: autograd {g00:.6g}, central "
        f"difference (eps {eps}) {fd:.6g}, rel {fd_rel:.3g} (≤ 2e-2)")
    if not fd_rel <= 2e-2:
        raise AssertionError("(d) the light_L gradient disagrees with its finite difference")

    # ---- 10. environment light and the flat BVH
    phases.start("10 env + bvh")
    from curry_pbrt_tpu_torch.ops import bvh as PB
    from curry_pbrt_tpu_torch.ops.kernels import bvh_kernel as BK
    from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX
    from curry_pbrt_tpu_torch.tools.env_scene import make_env_scene

    def bvh_alone(launches):
        """The live-ray BVH walk launched (closest and any hit), no other
        traversal kernel; NEE's kernels may run beside it."""
        need = ("bvh_closest", "bvh_any")
        return min(launches[k] for k in need) > 0 and not any(
            v for k, v in launches.items() if k not in need + NEE_COUNTERS)

    # (a) the walk against its plain version: a soup of 5k triangles and 64
    # rotated, scaled spheres, and the sphere field's BVH, at 32k rays with
    # dead lanes, a batch whose t_max is each ray's hit t, an all-dead and an
    # all-live batch; its ms
    t0 = time.time()
    soup = bvh_soup(5000, 64, seed=1)
    soup_bvh = PB.device_bvh(PB.build_flat_bvh(soup), soup.tris, soup.spheres, dev)
    field_bvh = PB.device_bvh(PB.build_flat_bvh(field), field.tris, field.spheres, dev)
    log(f"[bvh] soup BVH: {soup_bvh.n_nodes} nodes over 5064 prims; spherefield10k BVH: "
        f"{field_bvh.n_nodes} nodes (native builds + device copies {time.time() - t0:.2f} s)")
    for bname, b, spread in (("soup5k+64 spheres", soup_bvh, 9.0),
                             ("spherefield10k", field_bvh, 45.0)):
        rays = make_rays(1 << 15, 90, (0, 0, 0), spread, dev)
        st = check_bvh(f"{bname}/32768", b, rays, reps=(20, 2))
        log(f"    bounds: closest {bvh_bound(st, False)}, any {bvh_bound(st, True)} (ms, by)")
        t_p, r_p = PB.bvh_traverse(b, *rays)
        check_bvh(f"{bname}/32768 t_max = hit t", b,
                  (rays[0], rays[1], torch.where(r_p >= 0, t_p, rays[2])))
        check_bvh(f"{bname}/32768 all dead", b, (rays[0], rays[1], torch.zeros_like(rays[2])))
        check_bvh(f"{bname}/32768 all live", b,
                  (rays[0], rays[1], torch.where(rays[2] > 0, rays[2], float(FLOAT_MAX))))

    # (b) the sphere field and mesh10k through intersector="bvh" at their
    # full bench configs, against the JAX anchors; the walk alone
    captured_bvh = {}
    bvh_capture = {"on": False, "calls": {}}

    def capturing_bvh(fn, key, want):
        def wrapped(b, o, d, t_max):
            if torch.cuda.is_current_stream_capturing():  # a chunk program's recording
                return fn(b, o, d, t_max)
            calls_k = bvh_capture["calls"]
            call = calls_k[key] = calls_k.get(key, 0) + 1
            if bvh_capture["on"] and call == want:
                captured_bvh[key] = (o.clone(), d.clone(), t_max.clone())
            return fn(b, o, d, t_max)
        return wrapped

    # bounce 2's hit (closest call 5) and its shadow rays (any call 3), as in phase 6
    BK.bvh_closest = capturing_bvh(BK.bvh_closest, "closest", 5)
    BK.bvh_any = capturing_bvh(BK.bvh_any, "any", 3)
    bvh_runs, bvhs = {}, {}
    for name in ("spherefield10k_256", "mesh10k_512"):
        fname, cres, cspp, cdepth, a_seg, a_sum = CONFIGS[name]
        sc = config_scene(name)
        t0 = time.time()
        bvhs[name] = PB.device_bvh(PB.build_flat_bvh(sc), sc.tris, sc.spheres, dev)
        torch.cuda.synchronize()
        t_build = time.time() - t0
        t0 = time.time()
        plan = plan_render(sc, device="cuda", intersector="bvh")
        torch.cuda.synchronize()
        t_plan = time.time() - t0
        bvh_capture.update(on=name == "mesh10k_512", calls={})
        torch.cuda.reset_peak_memory_stats(dev)  # over the warm-up, as in phase 6
        render_plan(plan, show_progress=False)  # warm-up: its chunk eager (captured), recorded
        torch.cuda.synchronize()
        bvh_capture["on"] = False
        K.reset_launches()  # counts of this path's run start here
        t0 = time.time()
        img, segments = render_plan(plan, show_progress=False, count_rays=True)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(K.LAUNCHES)
        checksum = float(img.astype(np.float64).sum())
        seg_rel, sum_rel = abs(segments - a_seg) / a_seg, abs(checksum - a_sum) / a_sum
        bvh_runs[name] = dict(wall=wall, segments=segments, launches=launches,
                              peak_gb=torch.cuda.max_memory_allocated(dev) / 2**30)
        log(f"[bvh] {name} through intersector=bvh on {card}: set-up, not render time: BVH build "
            f"(native builder + device copy) {t_build:.2f} s, plan {t_plan:.2f} s; render wall "
            f"{wall:.3f} s, {segments} segments ({segments / wall:.4g} seg/s), checksum "
            f"{checksum:.2f}; vs JAX anchors {a_seg} / {a_sum}: segments rel {seg_rel:.3g} "
            f"(≤ {SEG_RTOL}), checksum rel {sum_rel:.3g} (≤ {SUM_RTOL}); kernel path wall "
            f"{config_runs[name]['wall']:.3f} s (phase 6); launches {launches}, peak "
            f"{bvh_runs[name]['peak_gb']:.2f} GiB")
        if img.shape != (cres, cres, 3) or not np.isfinite(img).all():
            raise AssertionError(f"{name} (bvh): image has the wrong shape or non-finite values")
        if seg_rel > SEG_RTOL or sum_rel > SUM_RTOL:
            raise AssertionError(f"{name} (bvh) disagrees with the JAX anchors")
        if not bvh_alone(launches):
            raise AssertionError(f"{name} (bvh) did not run through the live-ray BVH walk alone: "
                                 f"{launches}")
        del plan
    m10_bvh = bvhs["mesh10k_512"]
    bvh_cl = check_bvh("mesh10k bvh bounce 2", m10_bvh, captured_bvh["closest"], reps=(20, 1))
    bvh_any = check_bvh("mesh10k bvh bounce-2 shadow rays", m10_bvh, captured_bvh["any"],
                        reps=(20, 1))
    m10_launches = bvh_runs["mesh10k_512"]["launches"]
    bvh_cl_b, bvh_any_b = bvh_bound(bvh_cl, False), bvh_bound(bvh_any, True)
    log(f"[bounds] BVH walks at mesh10k's bvh bounce-2 shape ({bvh_cl['n']} rays, "
        f"{bvh_cl['live']} live) on {card}: closest, live-ray walk {bvh_cl['ms']:.4f} ms, "
        f"device_ms {bvh_cl['dev_ms']:.4f} (plain {bvh_cl['plain_ms']:.3f}), bound "
        f"{bvh_cl_b[0]:.4f} ms ({bvh_cl_b[1]}; nodes, tri, sphere tests {bvh_cl['work']}); "
        f"shadow rays ({bvh_any['n']} rays, {bvh_any['live']} live): any, live-ray walk "
        f"{bvh_any['any_ms']:.4f} ms, device_ms {bvh_any['any_dev_ms']:.4f} (plain "
        f"{bvh_any['any_plain_ms']:.3f}), bound {bvh_any_b[0]:.4f} ms ({bvh_any_b[1]}; "
        f"{bvh_any['any_work']}); per mesh10k_512 bvh pass: {m10_launches['bvh_closest']} "
        f"closest + {m10_launches['bvh_any']} any launches")

    # (c) mesh10k_env_512 through the warp K1 / K2 and through the BVH walk:
    # each other's segments within 1e-4 and image sum within 1e-3; wall,
    # seg/s, launches and peak device memory of each
    env_path = make_env_scene(REPO / "build" / "env_scene" / "512", **ENV_CONFIG)
    env_sc = compile_scene_file(env_path)
    env_runs = {}
    for backend in ("kernel", "bvh"):
        plan = plan_render(env_sc, device="cuda", intersector=backend)
        torch.cuda.synchronize()
        K.reset_launches()  # counts of this path's run start here
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        # one pass of a fresh plan, so eager as render_scene's (phase 14 replays this config)
        img, segments = render_plan(plan, show_progress=False, count_rays=True, graph=False)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(K.LAUNCHES)
        env_runs[backend] = dict(img=img, wall=wall, segments=segments, launches=launches,
                                 peak_gb=torch.cuda.max_memory_allocated(dev) / 2**30,
                                 checksum=float(img.astype(np.float64).sum()))
        log(f"[env] mesh10k_env_512 ({ENV_CONFIG['res']}², {ENV_CONFIG['spp']} spp, depth "
            f"{ENV_CONFIG['depth']}) through {backend} on {card}: one pass (no warm-up of its "
            f"own), wall {wall:.3f} s, {segments} segments ({segments / wall:.4g} seg/s), "
            f"checksum {env_runs[backend]['checksum']:.2f}, peak device memory "
            f"{env_runs[backend]['peak_gb']:.2f} GiB (mesh10k_512 through the kernel, phase 6: "
            f"{config_runs['mesh10k_512']['peak_gb']:.2f} GiB); launches {launches}")
        if img.shape != (ENV_CONFIG["res"],) * 2 + (3,) or not np.isfinite(img).all():
            raise AssertionError(f"mesh10k_env ({backend}): wrong shape or non-finite values")
        alone = ran_alone(launches, "warp") and not any(
            v for k, v in launches.items() if k.startswith("bvh_")) \
            if backend == "kernel" else bvh_alone(launches)
        if not alone:
            raise AssertionError(f"mesh10k_env ({backend}) did not run through its own kernels "
                                 f"alone: {launches}")
        del plan
    ek, eb = env_runs["kernel"], env_runs["bvh"]
    env_seg_rel = abs(ek["segments"] - eb["segments"]) / eb["segments"]
    env_sum_rel = abs(ek["checksum"] - eb["checksum"]) / eb["checksum"]
    log(f"[env] kernel vs bvh: segments rel {env_seg_rel:.3g} (≤ {SEG_RTOL}), image sum rel "
        f"{env_sum_rel:.3g} (≤ {SUM_RTOL}), max |Δ| {np.abs(ek['img'] - eb['img']).max():.3g}")
    if env_seg_rel > SEG_RTOL or env_sum_rel > SUM_RTOL:
        raise AssertionError("mesh10k_env: the kernel and bvh renders disagree")
    # an (N, C) table of the 512-column map at the 4M-ray chunk is 8 GiB
    if ek["peak_gb"] > config_runs["mesh10k_512"]["peak_gb"] + 2.0:
        raise AssertionError("mesh10k_env through the kernel needs > 2 GiB more device memory "
                             "than mesh10k_512: the env pass materialises a per-lane table")

    # (d) the 128² cut through the kernel against its JAX anchor
    small_env = compile_scene_file(make_env_scene(REPO / "build" / "env_scene" / "128",
                                                  ENV_ANCHOR["res"], ENV_CONFIG["spp"],
                                                  ENV_CONFIG["depth"]))
    img, segments = render_scene(small_env, device="cuda", show_progress=False, count_rays=True)
    checksum = float(img.astype(np.float64).sum())
    seg_rel = abs(segments - ENV_ANCHOR["segments"]) / ENV_ANCHOR["segments"]
    sum_rel = abs(checksum - ENV_ANCHOR["checksum"]) / ENV_ANCHOR["checksum"]
    log(f"[env] mesh10k_env {ENV_ANCHOR['res']}² through the kernel on {card}: {segments} segments, "
        f"checksum {checksum:.4f}; vs the JAX anchor {ENV_ANCHOR['segments']} / "
        f"{ENV_ANCHOR['checksum']:.4f}: segments rel {seg_rel:.3g} (≤ {SEG_RTOL}), checksum rel "
        f"{sum_rel:.3g} (≤ {SUM_RTOL})")
    if not np.isfinite(img).all() or seg_rel > SEG_RTOL or sum_rel > SUM_RTOL:
        raise AssertionError("mesh10k_env 128² disagrees with its JAX anchor")

    # ---- 11. distributed: the sharded render and train step
    phases.start("11 distributed")
    import torch.distributed as dist

    from curry_pbrt_tpu_torch.parallel.mesh import make_mesh, make_sharded_train_step
    from curry_pbrt_tpu_torch.parallel.multihost import render_distributed, run_ranks

    dist_dir = REPO / "build" / "dist"
    dist_dir.mkdir(parents=True, exist_ok=True)
    run_tag = f"{os.getpid()}_{time.time_ns()}"

    def store(name):
        """A fresh file store for one group's rendezvous."""
        return f"file://{dist_dir / f'store_{name}_{run_tag}'}"

    head_path = REPO / "scenes" / "cornell_tex.pbrt"
    head_over = {"resolution": (res, res), "spp": spp, "max_depth": depth}
    small_over = {"resolution": (64, 64), "spp": spp, "max_depth": depth}
    dist.init_process_group("nccl", init_method=store("a"), world_size=1, rank=0)
    try:
        # (a) world size 1 over NCCL, in this process: the headline
        mesh1 = make_mesh(1, device="cuda")
        K.reset_launches()  # counts of the sharded path's run start here
        plain_before = calls["plain"]
        torch.cuda.synchronize()
        t0 = time.time()
        img_a = render_distributed(head_path, head_over, output=str(dist_dir / "head_nccl.png"),
                                   device="cuda")
        torch.cuda.synchronize()
        wall_a = time.time() - t0
        launches_a = dict(K.LAUNCHES)
        a_equal = same_bits(img_a, head_img)
        log(f"[dist] (a) world 1 over {dist.get_backend()}, render_distributed of cornell_tex "
            f"{res}² {spp} spp depth {depth} on {card}: wall {wall_a:.3f} s (scene compile, plan, "
            f"render, gather, PNG) vs phase 5's render_scene {head_wall:.3f} s (plan, render); "
            f"bit-equal to phase 5's image: {a_equal} (max |Δ| "
            f"{float(np.abs(img_a - head_img).max()):.3g}); launches {launches_a}, plain calls "
            f"on CUDA {calls['plain'] - plain_before}")
        if not a_equal:
            raise AssertionError("(a) the world-1 NCCL image is not phase 5's, bit for bit")
        if calls["plain"] != plain_before or not ran_alone(launches_a, ctab.plan):
            raise AssertionError(f"(a) did not run through the plan's K1 / K2 ({ctab.plan} "
                                 f"walk) alone")

        # (c) world size 1: the config-4 step of phase 9 (c) through the
        # sharded step, from the texture at 0.5
        with torch.no_grad():
            tex.fill_(0.5)
        tex.grad = None
        sstep = make_sharded_train_step(plan_h, mesh1, torch.optim.Adam([tex], lr=0.05))
        K.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        s_losses, s_stats = [], []
        for k in range(3):
            times = {}
            torch.cuda.synchronize()
            t0 = time.time()
            s_losses.append(float(sstep(params_h, target, po_h, px_h, times=times)))
            s_stats.append((time.time() - t0, times))
            if k == 0:
                c_bits = torch.equal(tex.grad, step1_grad)
                c_rel = float((tex.grad - step1_grad).abs().max() / step1_grad.abs().max())
        launches_c11 = dict(K.LAUNCHES)
        with torch.no_grad():
            img_3 = torch.as_tensor(
                render_plan(plan_h, params_h, show_progress=False).reshape(-1, 3), device=dev)
            s_losses.append(float(mse(img_3, slice(None))))
        s_peak = torch.cuda.max_memory_allocated(dev) / 2**30
        for k, (w, times) in enumerate(s_stats):
            log(f"[dist] (c) world 1, sharded step {k + 1} on {card}: loss before "
                f"{s_losses[k]:.6g}, {w:.3f} s (forward {times['forward_s']:.3f}, backward "
                f"{times['backward_s']:.3f}, all-reduce {times['allreduce_s']:.4f})")
        log(f"[dist] (c) world 1: texel gradient at 0.5 bit-equal to make_train_step's (phase 9 "
            f"(c) step 1): {c_bits} (max rel {c_rel:.3g}); loss {s_losses[0]!r} vs "
            f"{losses[0]!r}; losses {s_losses}; peak device memory {s_peak:.2f} GiB; launches "
            f"{launches_c11}")
        if not c_bits or s_losses[0] != losses[0]:
            raise AssertionError("(c) the world-1 sharded step's gradient or loss is not "
                                 "make_train_step's")
        if not all(b < a for a, b in zip(s_losses, s_losses[1:])):
            raise AssertionError(f"(c) the sharded step's loss did not fall: {s_losses}")
        if not ran_alone(launches_c11, ctab.plan):
            raise AssertionError("(c) did not run through the plan's K1 / K2 alone")

        # the 1-rank gradient at 64² (the texture at 0.5, the MSE against the
        # 64² render), for the two ranks of (b) to match
        small_s = compile_scene_file(head_path, overrides=small_over)
        plan64 = plan_render(small_s, device="cuda")
        po64, px64 = pixel_arrays(plan64)
        target64 = render_plan(plan64, show_progress=False).reshape(-1, 3)
        stem = str(dist_dir / f"rank_{run_tag}")
        np.save(stem + "_target64.npy", target64)
        params64 = leaf_params(small_s.init_params, dev)
        tex64 = params64["textures"][tex_key]
        with torch.no_grad():
            tex64.fill_(0.5)
        tex64.requires_grad_(True)
        step64 = make_sharded_train_step(plan64, mesh1, torch.optim.SGD([tex64], lr=0.0))
        loss64 = float(step64(params64, torch.as_tensor(target64, device=dev), po64, px64))
        g64 = tex64.grad.cpu().numpy()
    finally:
        dist.destroy_process_group()

    # (b) two rank processes sharing the card over gloo: the headline, then
    # the 64² gradient through the sharded step
    del img_3
    torch.cuda.empty_cache()
    code = RANK_CODE.format(repo=str(REPO), scene=str(head_path), head=head_over,
                            small=small_over)
    t0 = time.time()
    results = run_ranks(lambda r: [sys.executable, "-c", code, str(r), store("b"), stem], 2,
                        timeout=600)
    wall_b = time.time() - t0
    reports = []
    for r, (rc, out, err) in enumerate(results):
        if rc != 0:
            raise AssertionError(f"(b) rank {r} failed ({rc}):\n{out[-2000:]}\n{err[-4000:]}")
        reports.append(json.loads(out.strip().splitlines()[-1]))
    imgs_b = [np.load(f"{stem}_head_{r}.npy") for r in range(2)]
    grads_b = [np.load(f"{stem}_grad64_{r}.npy") for r in range(2)]
    b_equal = same_bits(imgs_b[0], imgs_b[1]) and same_bits(imgs_b[0], img_a)
    g_rel = float(np.abs(grads_b[0] - g64).max() / np.abs(g64).max())
    for rep in reports:
        log(f"[dist] (b) rank {rep['rank']} of 2 on cuda:{rep['device']} ({card}), gloo: "
            f"render_distributed of the headline {rep['wall_s']:.3f} s (scene compile, group "
            f"join, plan, its slab, gather, PNG); the 64² sharded step {rep['step_s']:.3f} s, loss "
            f"{rep['loss']:.6g}; peak device memory {rep['peak_gib']:.2f} GiB; launches "
            f"{rep['launches']}")
    log(f"[dist] (b) two ranks on one card: {wall_b:.1f} s for both processes; headline images "
        f"equal to each other and bit-equal to (a): {b_equal}; 64² texel gradient (spp {spp}, "
        f"depth {depth}) rank 0 vs rank 1 bit-equal: {same_bits(grads_b[0], grads_b[1])}, vs 1 "
        f"rank max rel {g_rel:.3g} (≤ 1e-5); loss {reports[0]['loss']:.6g} vs 1 rank "
        f"{loss64:.6g}")
    if not b_equal:
        raise AssertionError("(b) the two ranks' headline images are not (a)'s, bit for bit")
    if not same_bits(grads_b[0], grads_b[1]) or not g_rel <= 1e-5:
        raise AssertionError(f"(b) the 2-rank gradient differs from the 1-rank one by {g_rel:.3g}")
    need, _ = walk_counters(ctab.plan)
    if not all(rep["launches"][k] > 0 for rep in reports for k in need):
        raise AssertionError("(b) a rank did not launch the plan's K1 / K2")

    # ---- 12. the per-stage profiler and the examples
    phases.start("12 stages and examples")
    from curry_pbrt_tpu_torch import cli
    from curry_pbrt_tpu_torch.tools import profile_stages as PS

    # (a) the stages at the headline's shape, on its plan's tables
    plain_before = calls["plain"]
    torch.cuda.reset_peak_memory_stats()
    stages = PS.run("cornell_tex.pbrt", (res, res), spp, depth, n=PS.HEADLINE_N, reps=3,
                    device="cuda")
    log(f"[stages] {card}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(PS.table(stages))
    log(PS.json_line(stages))
    need, _ = walk_counters(ctab.plan)
    # NEE under no_grad on the headline's plan: csrc/nee.cu's two kernels too
    traversing = {"intersect closest": need[:1], "predicate": need[1:],
                  "NEE total": need + NEE_COUNTERS,
                  "full bounce (isect+NEE+sample)": need + NEE_COUNTERS,
                  "chunk": need + NEE_COUNTERS}
    for name, r in stages["stages"].items():
        if not r["finite"]:
            raise AssertionError(f"(a) stage {name!r}: its output is not finite")
        launched = {k for k, v in r["traversal_launches"].items() if v}
        if launched != set(traversing.get(name, ())):
            raise AssertionError(f"(a) stage {name!r} launched {sorted(launched)}, not the "
                                 f"{ctab.plan} walk's {list(traversing.get(name, ()))} alone")
    if calls["plain"] != plain_before:
        raise AssertionError("(a) a plain version ran on the card")
    chunk = stages["stages"]["chunk"]
    log(f"[stages] chunk: wall {chunk['wall_ms']:.3f} ms, device {chunk['device_ms']:.3f} ms a "
        f"repetition; phase 5's pass wall over its 4 chunks {head_wall / 4 * 1e3:.3f} ms (plan "
        f"included)")

    # (b) the render_from_file example in its own process against the cli
    ex_dir = REPO / "build" / "examples"
    ex_dir.mkdir(parents=True, exist_ok=True)
    ex_args = [str(REPO / "scenes" / "cornell_tex.pbrt"), "--res", "64", "64", "--spp", "4",
               "--quiet"]
    # run() kills the process at its time limit (communicate(timeout=...))
    proc = subprocess.run([sys.executable, "-m", "curry_pbrt_tpu_torch.examples.render_from_file",
                           *ex_args, "-o", str(ex_dir / "example.png")], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"(b) the render_from_file example failed: {proc.stderr[-2000:]}")
    cli.main([*ex_args, "-o", str(ex_dir / "cli.png")])
    ex_png, cli_png = (ex_dir / "example.png").read_bytes(), (ex_dir / "cli.png").read_bytes()
    log(f"[examples] render_from_file (cornell_tex 64², 4 spp, on the card, own process) wrote "
        f"{len(ex_png)} bytes; byte-equal to the cli's PNG: {ex_png == cli_png}")
    if ex_png != cli_png:
        raise AssertionError("(b) the example's PNG differs from the cli's")

    # (c) the NEE split at the headline's shape, on its plan's tables
    from curry_pbrt_tpu_torch.tools import probe_sphere_kernel as PSK
    from curry_pbrt_tpu_torch.tools import profile_nee as PN

    plain_before = calls["plain"]
    nee = PN.run("cornell_tex.pbrt", (res, res), spp, depth, n=PS.HEADLINE_N, reps=3,
                 device="cuda")
    log(f"[nee] {card}")
    log(PS.table(nee, "pieces"))
    log(PS.json_line(nee, "pieces"))
    traversing = {"light strategy (eval+shadow+weights)": need[1:],
                  "bsdf strategy (sample+isect+le_pdf)": need[:1], "offset+intersect": need[:1],
                  "full NEE": need + NEE_COUNTERS}
    for name, r in nee["pieces"].items():
        if not r["finite"]:
            raise AssertionError(f"(c) piece {name!r}: its output is not finite")
        launched = {k for k, v in r["traversal_launches"].items() if v}
        if launched != set(traversing.get(name, ())):
            raise AssertionError(f"(c) piece {name!r} launched {sorted(launched)}, not the "
                                 f"{ctab.plan} walk's {list(traversing.get(name, ()))} alone")
    if calls["plain"] != plain_before:
        raise AssertionError("(c) a plain version ran on the card")
    nee_total = stages["stages"]["NEE total"]["device_ms"]
    log("[nee] device ms a repetition beside (a)'s NEE total "
        f"({nee_total:.3f} ms): " + "; ".join(
            f"{name} {r['device_ms']:.3f} ({r['device_ms'] / nee_total:.1%})"
            for name, r in nee["pieces"].items()))

    # (d) the dense sphere path against K3 at 10,000 spheres
    before = dict(K.LAUNCHES)
    probe = PSK.run(10_000, 32_768, reps=10, device="cuda")
    k3 = {k: v - before[k] for k, v in K.LAUNCHES.items() if v != before[k]}
    log(f"[sphere probe] {card}; K3 launches {k3}")
    log(PSK.report(probe))
    if not probe["agree"]["ok"]:
        raise AssertionError(f"(d) K3 and the dense path disagree: {probe['agree']}")
    if calls["plain"] != plain_before or not k3.get("sphere_closest") or not k3.get("sphere_any"):
        raise AssertionError(f"(d) the probe did not run through the warp K3 alone: {k3}")

    # ---- 13. the port's bench, in full
    phases.start("13 bench")
    from curry_pbrt_tpu_torch import bench

    torch.cuda.empty_cache()  # the bench's processes share the card
    names = [bench.HEADLINE_NAME, *bench.SECONDARY]
    if sorted(bench.EXPECTED_CUDA_CHECKSUMS) != sorted(names):
        raise AssertionError(f"the bench stores checksums for "
                             f"{sorted(bench.EXPECTED_CUDA_CHECKSUMS)}, not for its configs {names}")
    # run() kills the process at its time limit
    proc = subprocess.run([sys.executable, "-m", "curry_pbrt_tpu_torch.bench"], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
                          text=True, timeout=BENCH_TIMEOUT_S)
    out_lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not out_lines:
        raise AssertionError(f"the bench exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    result = json.loads(out_lines[-1])
    configs = result["configs"]
    if list(configs) != names or any("error" in c for c in configs.values()):
        raise AssertionError(f"the bench ran {list(configs)}, not {names} without an error")
    if "checksum_failures" in result or "anchor_failures" in result:
        raise AssertionError("the bench's gates failed")
    log(f"[bench] {result['device']['name']}, {result['device']['power_limit']}: headline "
        f"{result['value']:.4g} {result['unit']}, vs JAX CPU {result['vs_baseline']}")
    for name, c in configs.items():
        a_seg, a_sum = bench.ANCHORS[name]
        log(f"[bench] {name}: wall {c['wall_s']:.4f} s (passes {c['walls_s']}), {c['segments']} "
            f"segments, {c['rays_per_sec']:.4g} seg/s, checksum {c['checksum']} (stored "
            f"{bench.EXPECTED_CUDA_CHECKSUMS[name]}); vs JAX anchors: segments rel "
            f"{abs(c['segments'] - a_seg) / a_seg:.3g}, checksum rel "
            f"{abs(c['checksum'] - a_sum) / a_sum:.3g}; vs_baseline {c.get('vs_baseline')}")
    # the same renders in this process (phases 5 and 6): their unrounded sums
    earlier = {bench.HEADLINE_NAME: head_checksum,
               **{n: r["checksum"] for n, r in config_runs.items()}}
    log("[bench] unrounded sums bit-equal to phases 5 and 6's renders of the same configs: "
        + ", ".join(f"{n} {float.fromhex(configs[n]['checksum_hex']) == s}"
                    for n, s in earlier.items())
        + f"; {bench.FULL} {configs[bench.FULL]['checksum_hex']}")
    log(f"[bench] JSON line: {out_lines[-1]}")

    # ---- 14. graph A/B: render_plan's chunk program against its eager loop
    phases.start("14 graph A/B")

    captured.clear()  # phase 7's rays
    torch.cuda.empty_cache()
    ab_configs = [("headline", head, "kernel")]
    ab_configs += [(name, config_scene(name), "kernel") for name in CONFIGS]
    ab_configs += [("mesh10k_512 bvh", config_scene("mesh10k_512"), "bvh"),
                   ("mesh10k_env_512", env_sc, "kernel")]
    for name, sc, inter in ab_configs:
        t0 = time.time()
        plan = plan_render(sc, device="cuda", intersector=inter)
        torch.cuda.synchronize()
        t_plan = time.time() - t0
        r = graph_ab(plan)
        busy = "; ".join(
            f"{path} {r['busy'][g]['ms']:.1f} ms = {r['busy_share'][g]:.1%} of the median wall "
            f"({r['busy'][g]['device_ops']} device ops, profiled wall {r['busy'][g]['wall']:.4f} s "
            f"with a synchronise a chunk)"
            for g, path in ((False, "eager"), (True, "replayed")))
        counted = "; ".join(
            f"{path} " + ", ".join(f"{k}{'.' + part if part else ''} {n}"
                                   for (k, part), n in sorted(r["busy"][g]["kernels"].items()))
            for g, path in ((False, "eager"), (True, "replayed")))
        log(f"[graph] {name} ({inter}) on {card}: plan {t_plan:.2f} s, recording "
            f"{r['record_s']:.3f} s (set-up; programs {r['programs']}, {r['replays']} replays "
            f"in 6 passes); walls eager {r['walls'][False]} (median "
            f"{r['median'][False]:.4f} s), replayed {r['walls'][True]} (median "
            f"{r['median'][True]:.4f} s): replayed / eager "
            f"{r['median'][True] / r['median'][False]:.3f}; "
            f"{r['segments']} segments ({r['segments'] / r['median'][True]:.4g} seg/s replayed); "
            f"every pass bit-equal to the first with its segments, launches and sorts: "
            f"{r['equal']} (max |Δ| {r['max_abs']:.3g}); launches a pass "
            f"{ {k: v for k, v in r['launches'].items() if v} }, sorted traversals {r['sorts']}; "
            f"device busy: {busy}; peak device memory allocated / reserved: eager "
            f"{r['eager_mem'][0]:.3f} / {r['eager_mem'][1]:.3f} GiB, recording + replay "
            f"{r['graph_mem'][0]:.3f} / {r['graph_mem'][1]:.3f} GiB")
        log(f"[graph] {name}: the port's kernels among the card's events of each profiled pass "
            f"(a profiler session a chunk): "
            f"{counted}; each equal to the pass's launch counts: eager "
            f"{r['busy'][False]['matched']}, replayed {r['busy'][True]['matched']}")
        if not (r["busy"][False]["matched"] and r["busy"][True]["matched"]):
            raise AssertionError(f"{name}: the kernels that ran on the card are not the launches "
                                 f"the wrappers counted; the card's kernels: "
                                 f"{r['busy'][False]['names'] + r['busy'][True]['names']}")
        if not r["equal"] or not np.isfinite(r["img"]).all():
            raise AssertionError(f"{name}: a replayed pass is not the eager loop's, bit for bit, "
                                 f"with its segments, launches and sorts")
        if name.startswith("spherefield"):
            # the params copy into the recorded tree, once a render_plan call
            params = params_from_numpy(sc.init_params, dev)
            n_leaves = len(plan.programs.leaves)
            copy_ms = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                plan.programs.load(params)
                torch.cuda.synchronize()
                copy_ms.append((time.perf_counter() - t0) * 1e3)
            log(f"[graph] {name}: the params tree's copy into the recorded tree ({n_leaves} "
                f"leaves, {max(len(f.members) for f in plan.ctx.families)} members in its family; "
                f"check + torch._foreach_copy_ to a synchronise), five in a row: {copy_ms} ms")
        del plan
    one_shot = {False: [], True: []}
    for graph in (True, False, False, True):
        torch.cuda.synchronize()
        t0 = time.time()
        img = render_plan(plan_render(head, device="cuda"), show_progress=False, graph=graph)
        torch.cuda.synchronize()
        one_shot[graph].append(time.time() - t0)
        if not same_bits(img, head_img):
            raise AssertionError(f"the one-shot headline (graph={graph}) is not phase 5's image")
    log(f"[graph] one-shot headline, a fresh plan's one render_plan pass (plan, first chunk "
        f"eager, recording, replays; render_scene's eager pass) on {card}: replayed {one_shot[True]} s, eager {one_shot[False]} s; all four "
        f"bit-equal to phase 5's image")

    phases.start()
    # ---- report
    wsrc = "curry_pbrt_tpu_torch/csrc/intersect_warp.cu"
    ssrc = "curry_pbrt_tpu_torch/csrc/intersect_small.cu"
    field_l = config_runs["spherefield10k_256"]["launches"]
    m100_l = config_runs["mesh100k_512"]["launches"]

    def entry(name, replaces, launches, err, ms, plain_ms, b, source):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b[0], "bound_by": b[1], "library_ms": None}

    tri_k = "curry_pbrt_tpu/ops/pallas/intersect_kernel.py"
    sph_k = "curry_pbrt_tpu/ops/pallas/sphere_kernel.py"
    grp_k = "curry_pbrt_tpu/ops/pallas/intersect_group.py"
    grp_src = "curry_pbrt_tpu_torch/csrc/intersect_group.cu"
    bsrc = "curry_pbrt_tpu_torch/csrc/bvh_walk.cu"
    # K1 / K2: the warp walk at mesh100k's bounce-2 shapes (its render path:
    # launches per pass), the small-table walk at the synthetic headline
    # shape (launches per headline pass; K1b's in phase 7)
    kernels = [
        entry("tri_closest_hit", f"{tri_k}:709", m100_l["tri_closest"], st100["max_abs_err"],
              st100["ms"], st100["plain_ms"], k1_100_b, wsrc),
        entry("tri_any_hit", f"{tri_k}:760", m100_l["tri_any"], any100["max_abs_err"],
              any100["ms"], any100["plain_ms"], k2_100_b, wsrc),
        entry("tri_closest_hit_stats", f"{tri_k}:712", stats_launches,
              st100["stats_max_abs_err"], st100["stats_ms"], st100["stats_plain_ms"], k1s_b, wsrc),
        entry("tri_closest_hit_small", f"{tri_k}:709", head_launches["tri_closest_small"],
              head_shape["small_max_abs_err"], head_shape["closest_small_ms"],
              head_shape["closest_plain_ms"], k1_b, ssrc),
        entry("tri_any_hit_small", f"{tri_k}:760", head_launches["tri_any_small"],
              head_shape["any_small_max_abs_err"], head_shape["any_small_ms"],
              head_shape["any_plain_ms"], k2_b, ssrc),
        entry("tri_closest_hit_stats_small", f"{tri_k}:712", stats_small_launches,
              head_stats["stats_small_max_abs_err"], head_stats["stats_ms"],
              head_stats["stats_plain_ms"], k1s_head_b, ssrc),
        # K3: the warp walk at the sphere field's bounce-1 shapes, its
        # launches per pass
        entry("sphere_closest_hit", f"{sph_k}:216", field_l["sphere_closest"],
              f_cl["max_abs_err"], f_cl["closest_ms"], f_cl["closest_plain_ms"], k3c_b, wsrc),
        entry("sphere_any_hit", f"{sph_k}:256", field_l["sphere_any"], f_any["any_max_abs_err"],
              f_any["any_ms"], f_any["any_plain_ms"], k3a_b, wsrc),
        # K4 at mesh10k's A/B bounce 2 (launches: the phase-8 A/B's); the
        # bound the function's (K1's / K2's tiles)
        entry("tri_closest_hit_groups", f"{grp_k}:345", ab_launches["tri_closest_group"],
              r2["max_abs_err"], r2["k4_ms"], r2["plain_ms"], k4c_b, grp_src),
        entry("tri_any_hit_groups", f"{grp_k}:382", ab_launches["tri_any_group"],
              r2["any_max_abs_err"], r2["k4_any_ms"], r2["any_plain_ms"], k4a_b, grp_src),
        entry("slab_grid_probe", "tools/probe_slab_grid.py:34", p_launches, p_big[1], p_ms,
              p_plain_ms, p_b, "curry_pbrt_tpu_torch/csrc/slab_grid.cu"),
        # the BVH walk (no TPU counterpart: it replaces a jnp while_loop) at
        # mesh10k's bvh bounce-2 shapes, its launches per mesh10k_512 bvh pass
        entry("bvh_closest_hit", "curry_pbrt_tpu/ops/bvh.py:298",
              m10_launches["bvh_closest"], bvh_cl["max_abs_err"],
              bvh_cl["ms"], bvh_cl["plain_ms"], bvh_cl_b, bsrc),
        entry("bvh_any_hit", "curry_pbrt_tpu/ops/bvh.py:298",
              m10_launches["bvh_any"], bvh_any["any_max_abs_err"],
              bvh_any["any_ms"], bvh_any["any_plain_ms"], bvh_any_b, bsrc),
        # the texel gather's backward (no TPU counterpart: XLA's scatter-add)
        # at a sub-chunk's shape, its launches per config-4 step, the whole
        # backward (sort included) against index_put_
        entry("texel_grad", "none (the VJP of eval_texref's gather)", step_tg[0], tg_err,
              tg_k["whole"], tg_plain_ms, tg_b, "curry_pbrt_tpu_torch/csrc/texel_grad.cu"),
        # next-event estimation's two kernels (no TPU counterpart: the JAX
        # package's uniform_sample_one_light is jnp) per headline pass, from
        # phase 7b's middle chunk: their device ms, the plain path's whole
        # call (its walks included) and their bytes bound; launches a pass
        entry("nee_sample", "none (jnp: uniform_sample_one_light)", head_launches["nee_sample"],
              max(st["max_abs_err"] for st in nee_runs["headline"]),
              head_nee["nee_sample_dev_ms"], head_nee["plain_ms"],
              (head_nee["bound"][0], "bytes"), "curry_pbrt_tpu_torch/csrc/nee.cu"),
        entry("nee_finish", "none (jnp: uniform_sample_one_light)", head_launches["nee_finish"],
              max(st["max_abs_err"] for st in nee_runs["headline"]),
              head_nee["nee_finish_dev_ms"], head_nee["plain_ms"],
              (head_nee["bound"][1], "bytes"), "curry_pbrt_tpu_torch/csrc/nee.cu"),
    ]
    log(f"[total] chip_smoke ran {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
