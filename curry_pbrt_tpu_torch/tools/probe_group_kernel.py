"""A/B of the per-ray kernels K1 / K2 against the group kernel K4 on the
shared per-bounce workload.

    python -m curry_pbrt_tpu_torch.tools.probe_group_kernel [scenes ...] [--rays N] [--depth D] [--device cpu]

Counterpart of the JAX package's tools/probe_group_kernel.py. K1 / K2 run
on the render path's tables (aggregate.plan_tri_kernel); K4 on its own
tables at block_t 128, clusters_per_slab 128, supers on (intersect_group.
group_tables). Per bounce it reports:
  - whether K4's t is bit-equal to K1's;
  - prim mismatches (the winning rows mapped through each table's prim),
    and how many of them are not exact-t ties — those must be 0;
  - any-hit mismatches, on t_max shrunk to 0.999 of K1's closest t for hits
    (a shadow-like bound), which must be 0;
  - each kernel's time by CUDA events (closest K1 / K4, any K2 / K4).
On the CPU the kernels' plain versions run and no time is measured.
"""

from __future__ import annotations

import argparse

import torch

from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX
from curry_pbrt_tpu_torch.ops.intersect import ray_shear, watertight_core
from curry_pbrt_tpu_torch.ops.kernels.intersect_group import (
    group_kw,
    group_tables,
    tri_any_hit_groups,
    tri_closest_hit_groups,
)
from curry_pbrt_tpu_torch.ops.kernels.intersect_kernel import DeviceTables
from curry_pbrt_tpu_torch.tools.roofline import cuda_ms
from curry_pbrt_tpu_torch.tools.workload import Workload, load_scene


def row_t(tris16, o, d, t_max, rows):
    """t of each ray against one given table row (-1 → FLOAT_MAX)."""
    tri = tris16[rows.clamp(min=0).long()]
    kz, sx, sy, sz = ray_shear(d)
    t, _, ok = watertight_core(o, kz, sx, sy, sz, t_max, tri[:, 0:3], tri[:, 3:6], tri[:, 6:9],
                               with_bary=False)
    return torch.where(ok & (tri[:, 9] > 0) & (rows >= 0), t, float(FLOAT_MAX))


def non_tie_mismatches(a_tab, a_prim, a_rows, b_tab, b_prim, b_rows, o, d, t_max) -> tuple:
    """(prim mismatches, those that are not exact-t ties): a mismatch is a
    tie when both rows give the ray the same t."""
    pa = torch.where(a_rows >= 0, a_prim[a_rows.clamp(min=0).long()], -1)
    pb = torch.where(b_rows >= 0, b_prim[b_rows.clamp(min=0).long()], -1)
    diff = pa != pb
    n = int(diff.sum())
    if not n:
        return 0, 0
    ta = row_t(a_tab.tris16, o[diff], d[diff], t_max[diff], a_rows[diff])
    tb = row_t(b_tab.tris16, o[diff], d[diff], t_max[diff], b_rows[diff])
    return n, int((ta != tb).sum())


class Pair:
    """The render path's tables (K1 / K2) and K4's, on one device."""

    def __init__(self, wl: Workload, host_k4=None):
        sc = wl.scene
        self.k1 = wl.tables
        self.k4_host = host_k4 or group_tables(sc.tris.p0, sc.tris.p1, sc.tris.p2, sc.tris.prim,
                                               view_origin=wl.view)
        self.k4 = DeviceTables(self.k4_host, wl.device)
        as_t = lambda a: torch.as_tensor(a, device=wl.device)  # noqa: E731
        self.prim1, self.prim4 = as_t(wl.host.prim), as_t(self.k4_host.prim)
        self.kw4 = group_kw(self.k4)

    def k4_args(self, o, d, t_max):
        return (o, d, t_max, self.k4.tris16, self.k4.caabb, self.k4.saabb, self.k4.slab_aabb)

    def closest4(self, o, d, t_max):
        return tri_closest_hit_groups(*self.k4_args(o, d, t_max), **self.kw4)

    def any4(self, o, d, t_max):
        return tri_any_hit_groups(*self.k4_args(o, d, t_max), **self.kw4)


def analyze(scene_name, n_rays: int, depth: int, device="cuda", seed: int = 0,
            reps: int = 5, wl: Workload = None, keep=()) -> dict:
    """The per-bounce A/B on one scene → summary dict. keep: bounce indices
    whose (o, d, t_max) are returned under "inputs" (for timing elsewhere)."""
    wl = wl or Workload(load_scene(scene_name), device)
    p = Pair(wl)
    on_card = wl.device.type == "cuda"
    rows, inputs = [], {}
    for b in wl.bounces(n_rays, depth, seed):
        t4, r4 = p.closest4(b.o, b.d, b.t_max)
        n_mis, n_bad = non_tie_mismatches(p.k1, p.prim1, b.row, p.k4, p.prim4, r4,
                                          b.o, b.d, b.t_max)
        tm_s = torch.where(b.t < 1e29, b.t * 0.999, b.t_max)
        h2 = p.k1.any_hit(b.o, b.d, tm_s)
        h4 = p.any4(b.o, b.d, tm_s)
        r = {"bounce": b.index, "active": b.active, "hits": int(b.hit.sum()),
             "t_bit_equal": bool(torch.equal(b.t, t4)),
             "t_mismatches": int((b.t != t4).sum()),
             "prim_mismatches": n_mis, "non_tie_prim_mismatches": n_bad,
             "any_mismatches": int((h2 != h4).sum()), "any_hits": int(h2.sum()),
             "k1_ms": None, "k4_ms": None, "k2_ms": None, "k4_any_ms": None}
        if on_card:
            o, d, tm = b.o, b.d, b.t_max
            r["k1_ms"] = cuda_ms(lambda: p.k1.closest(o, d, tm), reps)
            r["k4_ms"] = cuda_ms(lambda: p.closest4(o, d, tm), reps)
            r["k2_ms"] = cuda_ms(lambda: p.k1.any_hit(o, d, tm_s), reps)
            r["k4_any_ms"] = cuda_ms(lambda: p.any4(o, d, tm_s), reps)
        if b.index in keep:
            inputs[b.index] = (b.o, b.d, b.t_max, tm_s)
        rows.append(r)
    tot = {k: (sum(r[k] for r in rows) if on_card else None)
           for k in ("k1_ms", "k4_ms", "k2_ms", "k4_any_ms")}
    return {"scene": str(scene_name), "device": str(wl.device), "rays": int(b.o.shape[0]),
            "depth": depth, "k1_tables": dict(p.k1.kw, clusters=int(p.k1.caabb.shape[0]),
                                              slabs=int(p.k1.slab_aabb.shape[0])),
            "k4_tables": dict(p.kw4, clusters=int(p.k4.caabb.shape[0]),
                              slabs=int(p.k4.slab_aabb.shape[0])),
            "bounces": rows, "totals": tot, "inputs": inputs, "pair": p}


def check(s: dict) -> None:
    """Raise unless every bounce has t bit-equal, prims equal up to exact-t
    ties, and any-hit equal."""
    for r in s["bounces"]:
        if not r["t_bit_equal"] or r["non_tie_prim_mismatches"] or r["any_mismatches"]:
            raise AssertionError(f"{s['scene']} bounce {r['bounce']}: K4 disagrees with K1 / K2 "
                                 f"({r})")


def report(s: dict) -> str:
    k1, k4 = s["k1_tables"], s["k4_tables"]
    lines = [f"== {s['scene']} on {s['device']}: {s['rays']} rays; K1 tables {k1['clusters']} "
             f"clusters of {k1['block_t']} in {k1['slabs']} slab(s); K4 tables {k4['clusters']} "
             f"clusters of {k4['block_t']} in {k4['slabs']} slab(s)"]
    for r in s["bounces"]:
        line = (f"  bounce {r['bounce']}: active {r['active']:>8}, t bit-equal {r['t_bit_equal']}, "
                f"prim mismatches {r['prim_mismatches']} ({r['non_tie_prim_mismatches']} not "
                f"ties), any-hit mismatches {r['any_mismatches']}")
        if r["k1_ms"] is not None:
            line += (f"; closest K1 {r['k1_ms']:.4f} ms, K4 {r['k4_ms']:.4f} ms "
                     f"({r['k1_ms'] / r['k4_ms']:.2f}x); any K2 {r['k2_ms']:.4f} ms, K4 "
                     f"{r['k4_any_ms']:.4f} ms ({r['k2_ms'] / r['k4_any_ms']:.2f}x)")
        lines.append(line)
    t = s["totals"]
    if t["k1_ms"] is not None:
        lines.append(f"  totals: closest K1 {t['k1_ms']:.3f} ms, K4 {t['k4_ms']:.3f} ms; any K2 "
                     f"{t['k2_ms']:.3f} ms, K4 {t['k4_any_ms']:.3f} ms")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenes", nargs="*", default=["mesh10k.pbrt"])
    ap.add_argument("--rays", type=int, default=1 << 22)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    for name in args.scenes:
        s = analyze(name, args.rays, args.depth, args.device)
        print(report(s), flush=True)
        check(s)


if __name__ == "__main__":
    main()
