"""Tile work per ray-group granularity G, on the shared per-bounce workload.

    python -m curry_pbrt_tpu_torch.tools.probe_granularity [scenes ...] [--rays N] [--depth D] [--device cpu]

Counterpart of the JAX package's tools/probe_granularity.py. For each
bounce it counts the (group, cluster) pairs a cluster sweep would test if
the tile tests were gated per group of G consecutive rays — a pair is tested
when any ray of the group enters the cluster's box — for G in GROUPS, and
its work flops(G) = pairs · G · block_t · ops per test. The box bound is each
ray's CONVERGED best t (K1's final t for hits, t_max for misses, 0 for dead
lanes): the limit an ideal front-to-back sweep approaches. G = 1 is the
per-ray work (the CUDA kernel K1's granularity), G = 8 the group kernel K4's,
G = 256 the TPU kernel's sub-group.

Three ray orders, grouping consecutive rays after the sort:
  pixel     the workload's order (camera pixels, then each lane's bounce);
  oct_cell  the render path's sort key (aggregate.sort_key: direction
            octant, origin Morton cell; dead lanes last);
  first_c   each ray's first entered cluster (dead lanes last).

On the card the enter mask is computed in chunks of CHUNK rays (a multiple
of every G) and reduced per G at once: the whole (rays × clusters) mask is
never held (4M rays × 1,792 clusters would be 7.5 GB).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from curry_pbrt_tpu_torch.dtypes import Float, gamma
from curry_pbrt_tpu_torch.ops.kernels.aggregate import sort_key
from curry_pbrt_tpu_torch.tools.roofline import TRI_TEST_OPS
from curry_pbrt_tpu_torch.tools.workload import Workload, load_scene

GROUPS = (1024, 256, 128, 64, 32, 16, 8, 1)
ORDERS = ("pixel", "oct_cell", "first_c")
CHUNK = 1 << 15  # rays per enter-mask chunk: a multiple of every G


def slab_enter(o, inv_d, t_bound, caabb):
    """(N,3), (N,3), (N,), (C,8) → (N,C) bool: the kernels' box test (the
    (1+2γ₃) far-side widening, the dead-lane gate t_bound > 0, NaN boxes of
    empty clusters never entered), as the JAX probe computes it."""
    scale = float(Float(1.0 + 2.0 * gamma(3)))
    oo, ii = o[:, None, :], inv_d[:, None, :]
    t0 = (caabb[None, :, 0:3] - oo) * ii
    t1 = (caabb[None, :, 3:6] - oo) * ii
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = (torch.maximum(t0, t1) * scale).amin(dim=-1)
    tb = t_bound[:, None]
    return (tn <= tf) & (tn < tb) & (tf > 0) & (tb > 0)


def tiles_at(enter, g: int) -> int:
    """(group, cluster) pairs with any of the group's rays entering, for
    groups of g consecutive rays (a tail of fewer than g rays is dropped, as
    the JAX probe drops it)."""
    n = enter.shape[0] - enter.shape[0] % g
    return int(enter[:n].reshape(n // g, g, enter.shape[1]).any(dim=1).sum())


def flops_at(enter, g: int, block_t: int, ops: float = TRI_TEST_OPS) -> float:
    """The tile-test work at granularity g: pairs · g · block_t · ops."""
    return float(tiles_at(enter, g)) * g * block_t * ops


def _inv_d(d):
    return 1.0 / torch.where(d == 0, float(Float(1e-30)), d)


def bounce_tiles(o, d, t_bound, caabb, orders, chunk: int = CHUNK):
    """{order: {G: pairs}} over all rays, the enter mask built chunk by
    chunk of each order's permutation (orders: name → permutation, or None
    for first_c, which a first chunked pass computes)."""
    inv_d = _inv_d(d)
    n = o.shape[0]
    if "first_c" in orders and orders["first_c"] is None:
        first = torch.empty((n,), dtype=torch.int64, device=o.device)
        n_c = caabb.shape[0]
        for i in range(0, n, chunk):
            e = slab_enter(o[i:i + chunk], inv_d[i:i + chunk], t_bound[i:i + chunk], caabb)
            first[i:i + chunk] = torch.where(e.any(dim=1), e.to(torch.uint8).argmax(dim=1), n_c)
        first = torch.where(t_bound > 0, first, 1 << 20)
        orders = dict(orders, first_c=torch.argsort(first, stable=True))
    out = {}
    for name, perm in orders.items():
        counts = dict.fromkeys(GROUPS, 0)
        for i in range(0, n, chunk):
            idx = perm[i:i + chunk]
            e = slab_enter(o[idx], inv_d[idx], t_bound[idx], caabb)
            for g in GROUPS:
                counts[g] += tiles_at(e, g)
        out[name] = counts
    return out


def analyze(scene_name, n_rays: int, depth: int, device="cuda", seed: int = 0,
            chunk: int = CHUNK, wl: Workload = None) -> dict:
    """Per bounce and in total, pairs and work per order and G → dict (on
    a given Workload, or the scene's)."""
    wl = wl or Workload(load_scene(scene_name), device)
    host, caabb = wl.host, wl.tables.caabb
    sb = host.slab_aabbs
    lo3 = np.nanmin(sb[:, 0:3], axis=0)
    ext3 = np.maximum(np.nanmax(sb[:, 3:6], axis=0) - lo3, 1e-6)
    lo3, ext3 = (torch.as_tensor(a, device=wl.device) for a in (lo3, ext3))
    per_tile = host.block_t * TRI_TEST_OPS
    bounces, totals = [], {o: dict.fromkeys(GROUPS, 0) for o in ORDERS}
    for b in wl.bounces(n_rays, depth, seed):
        # converged bound: the final t for hits, t_max for misses, 0 dead
        t_bound = torch.minimum(torch.where(b.hit, b.t, b.t_max), b.t_max)
        orders = {"pixel": torch.arange(b.o.shape[0], device=wl.device),
                  "oct_cell": torch.argsort(sort_key(b.o, b.d, b.t_max, lo3, ext3), stable=True),
                  "first_c": None}
        tiles = bounce_tiles(b.o, b.d, t_bound, caabb, orders, chunk)
        for o in ORDERS:
            for g in GROUPS:
                totals[o][g] += tiles[o][g]
        bounces.append({"bounce": b.index, "active": b.active, "tiles": tiles})
    base = totals["pixel"][256] or 1
    return {
        "scene": str(scene_name), "device": str(wl.device), "rays": int(b.o.shape[0]),
        "depth": depth, "block_t": host.block_t, "clusters": int(caabb.shape[0]),
        "ops_per_tile_row": TRI_TEST_OPS, "groups": list(GROUPS), "bounces": bounces,
        "total_tiles": totals,
        "total_flops": {o: {g: totals[o][g] * g * per_tile for g in GROUPS} for o in ORDERS},
        "relative": {o: {g: totals[o][g] * g / (base * 256) for g in GROUPS} for o in ORDERS},
    }


def report(s: dict) -> str:
    head = " ".join(f"G={g:<6}" for g in s["groups"])
    lines = [f"== {s['scene']} on {s['device']}: {s['rays']} rays, depth {s['depth']}, "
             f"{s['clusters']} clusters of {s['block_t']}",
             f"work relative to order=pixel G=256, all bounces   | {head}"]
    for o in ORDERS:
        lines.append(f"{o:>49} | " + " ".join(f"{s['relative'][o][g]:<8.4f}" for g in s["groups"]))
    lines.append("(group, cluster) pairs per bounce, order=pixel     | " + head)
    for r in s["bounces"]:
        lines.append(f"  bounce {r['bounce']} ({r['active']:>8} live lanes)"
                     + " " * 12 + "| " + " ".join(f"{r['tiles']['pixel'][g]:<8}"
                                                  for g in s["groups"]))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenes", nargs="*", default=["mesh10k.pbrt"])
    ap.add_argument("--rays", type=int, default=1 << 22)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    for name in args.scenes:
        print(report(analyze(name, args.rays, args.depth, args.device)), flush=True)


if __name__ == "__main__":
    main()
