"""A/B of the per-ray kernels K1 / K2 against the group kernel K4 and its
baseline, and of the launch plan's K1 / K2 walk against the per-thread
walk, on the shared per-bounce workload.

    python -m curry_pbrt_tpu_torch.tools.probe_group_kernel [scenes ...] [--rays N] [--depth D] [--device cpu]

Counterpart of the JAX package's tools/probe_group_kernel.py. K1 / K2 run
on the render path's tables (aggregate.plan_tri_kernel), through the walk
intersect_kernel.launch_plan picks (the warp walk on the mesh scenes) and
through the per-thread walk (csrc/intersect.cu); K4 on its own tables at
block_t 128, clusters_per_slab 128, supers on (intersect_group.
group_tables), through the kernel (each ray tests only the clusters its own
gate lets in) and through the baseline (`*_group_rule`: every live ray of the
group tests every cluster the group visits). Per bounce it reports:
  - whether K4's t, and the baseline's, are bit-equal to the plain
    version's (the group rule), with rows equal to its rows (tie rows: 0)
    and any-hit equal;
  - whether K4's t, and the per-thread walk's, are bit-equal to K1's;
  - prim mismatches against K1 (the winning rows mapped through each
    table's prim), and how many of them are not exact-t ties — those must
    be 0 (for K4; for the per-thread walk, rows on the same tables);
  - any-hit mismatches, on t_max shrunk to 0.999 of K1's closest t for hits
    (a shadow-like bound), of K4, its baseline and the per-thread K2: they
    must be 0;
  - the tiles the plain versions count: the group rule's (ray-tiles of
    K4's rows, every ray of a visited cluster's group) and, at the bounces
    in `stats_at`, the gate's (the tiles the kernel tests) and K1's and
    K2's own (the function's least work);
  - each kernel's time on the card: K4 and its baseline in turns by CUDA
    events around back-to-back calls (cuda_ms) and by the card's time alone
    (device_ms); closest K1 / per-thread K1 and any K2 / per-thread K2 in
    turns; the plain versions' one call.
On the CPU the kernels' plain versions run and no time is measured.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX
from curry_pbrt_tpu_torch.ops.intersect import ray_shear, watertight_core
from curry_pbrt_tpu_torch.ops.kernels import intersect_group as G
from curry_pbrt_tpu_torch.ops.kernels.intersect_kernel import (
    DeviceTables,
    tri_any_hit_plain,
    tri_closest_hit_tables,
)
from curry_pbrt_tpu_torch.tools.roofline import device_ms, turns
from curry_pbrt_tpu_torch.tools.workload import Workload, load_scene


def face_tie_batch(n_soup: int = 4000, n_rays: int = 4096, seed: int = 0):
    """K4 tables (group_tables) and rays, host numpy, where the non-strict
    gate decides: a triangle on the z = 4 plane, the least z of the scene,
    so the near face of its cluster's box, and groups of 8 rays along +z
    through it, from z = 0. In group g, ray g % 8 has t_max = 4.0, the
    triangle's exact hit t — its first hit lies at exactly t_max, in a
    cluster whose box_near is exactly t_max, so a strict box test never
    lets it in — and the other seven rays, unbounded (t_max 1e30), enter
    the cluster, so the group visits it. Then random rays through a soup
    of n_soup triangles at z >= 5 (every 7th dead) fill the batch to
    n_rays. Returns (tables, (o, d, t_max), the tie rays' indices)."""
    rng = np.random.default_rng(seed)
    base = np.stack([rng.uniform(-8, 8, n_soup), rng.uniform(-8, 8, n_soup),
                     rng.uniform(5, 20, n_soup)], axis=1).astype(np.float32)
    p1 = base + rng.normal(0, 0.7, base.shape).astype(np.float32)
    p2 = base + rng.normal(0, 0.7, base.shape).astype(np.float32)
    for p in (p1, p2):
        p[:, 2] = np.maximum(p[:, 2], 5.0)
    face = np.array([[0, 0, 4], [2, 0, 4], [0, 2, 4]], np.float32)
    p0, p1, p2 = (np.concatenate([face[k:k + 1], a]) for k, a in enumerate((base, p1, p2)))
    tab = G.group_tables(p0, p1, p2, np.arange(p0.shape[0], dtype=np.int32),
                       view_origin=np.array([0.0, 0.0, -10.0]))
    n_tie = 64  # 8 groups of 8, the tie ray in each lane once
    k = np.arange(n_tie)
    o = np.zeros((n_rays, 3), np.float32)
    o[:n_tie, 0] = 0.25 + 0.0625 * (k % 8)  # 0.25 .. 0.6875: inside the triangle
    o[:n_tie, 1] = 0.25 + 0.0625 * (k // 8)
    d = np.zeros((n_rays, 3), np.float32)
    d[:n_tie, 2] = 1.0
    t_max = np.full((n_rays,), 1e30, np.float32)
    tie = np.flatnonzero(k % 8 == k // 8)
    t_max[tie] = 4.0
    m = n_rays - n_tie
    o[n_tie:] = np.stack([rng.uniform(-9, 9, m), rng.uniform(-9, 9, m), rng.uniform(-2, 0, m)],
                         axis=1)
    dr = rng.normal(0, 1, (m, 3)).astype(np.float32)
    dr[:, 2] = np.abs(dr[:, 2]) + 0.3
    d[n_tie:] = dr / np.linalg.norm(dr, axis=-1, keepdims=True)
    t_max[n_tie:][::7] = 0.0
    return tab, (o, d, t_max), tie


def coplanar_batch(n_quads: int = 400, n_rays: int = 4096, seed: int = 0,
                   block_t: int = 32, clusters_per_slab: int = 16):
    """K4 tables and rays, host numpy, where the gate's slack decides:
    n_quads random rectangles on the z = 4 plane, each cut along both
    diagonals into four coplanar, pairwise overlapping triangles, which the
    builder scatters over clusters whose boxes are flat in z; rays from
    z in [-3, 0] along +z (z the dominant axis), every 7th dead. A ray's hit
    on one triangle and on its overlapping twin in a later cluster differ
    by rounding and can fall below that cluster's box_near: a gate without
    the slack skips the twin, the group rule (its group visits) takes it.
    Returns (tables, (o, d, t_max))."""
    rng = np.random.default_rng(seed)
    x0, y0 = rng.uniform(-8, 8, n_quads), rng.uniform(-8, 8, n_quads)
    w, h = rng.uniform(0.3, 2, n_quads), rng.uniform(0.3, 2, n_quads)
    a, b = np.stack([x0, y0], 1), np.stack([x0 + w, y0], 1)
    c, e = np.stack([x0 + w, y0 + h], 1), np.stack([x0, y0 + h], 1)
    tris = ((a, b, c), (a, c, e), (a, b, e), (b, c, e))
    p0, p1, p2 = (np.concatenate([np.c_[t[k], np.full(n_quads, 4.0)] for t in tris])
                  .astype(np.float32) for k in range(3))
    tab = G.group_tables(p0, p1, p2, np.arange(p0.shape[0], dtype=np.int32),
                         view_origin=np.zeros(3), block_t=block_t,
                         clusters_per_slab=clusters_per_slab)
    o = np.stack([rng.uniform(-8, 8, n_rays), rng.uniform(-8, 8, n_rays),
                  rng.uniform(-3, 0, n_rays)], axis=1).astype(np.float32)
    d = rng.normal(0, 0.3, (n_rays, 3)).astype(np.float32)
    d[:, 2] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full((n_rays,), 100.0, np.float32)
    t_max[::7] = 0.0
    return tab, (o, d, t_max)


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
        self.k4_host = host_k4 or G.group_tables(sc.tris.p0, sc.tris.p1, sc.tris.p2,
                                                 sc.tris.prim, view_origin=wl.view)
        self.k4 = DeviceTables(self.k4_host, wl.device)
        as_t = lambda a: torch.as_tensor(a, device=wl.device)  # noqa: E731
        self.prim1, self.prim4 = as_t(wl.host.prim), as_t(self.k4_host.prim)
        self.kw4 = G.group_kw(self.k4)

    def k4_args(self, o, d, t_max):
        return (o, d, t_max, self.k4.tris16, self.k4.caabb, self.k4.saabb, self.k4.slab_aabb)

    def closest4(self, o, d, t_max):
        return G.tri_closest_hit_groups(*self.k4_args(o, d, t_max), **self.kw4)

    def any4(self, o, d, t_max):
        return G.tri_any_hit_groups(*self.k4_args(o, d, t_max), **self.kw4)

    def closest4_rule(self, o, d, t_max):
        return G.tri_closest_hit_group_rule(*self.k4_args(o, d, t_max), **self.kw4)

    def any4_rule(self, o, d, t_max):
        return G.tri_any_hit_group_rule(*self.k4_args(o, d, t_max), **self.kw4)

    def closest4_plain(self, o, d, t_max, gate=False):
        """The plain version with stats: (t, row, entered, improved)."""
        return G.tri_closest_hit_groups_plain(*self.k4_args(o, d, t_max), **self.kw4, stats=True,
                                              gate=gate)

    def any4_plain(self, o, d, t_max, gate=False):
        """The plain version with stats: (hit, entered)."""
        return G.tri_any_hit_groups_plain(*self.k4_args(o, d, t_max), **self.kw4, stats=True,
                                          gate=gate)


def same_bits(a, b) -> bool:
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def _t_err(t, t_ref) -> float:
    """max |t - t_ref| over the reference's hits."""
    hit = t_ref < 1e30
    return (t[hit] - t_ref[hit]).abs().max().item() if hit.any() else 0.0


def _h_err(h, h_ref) -> float:
    return (h.float() - h_ref.float()).abs().max().item() if h.numel() else 0.0


def _timed(fn, on_card: bool):
    """(fn(), its ms by CUDA events on the card, else None)."""
    if not on_card:
        return fn(), None
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def analyze(scene_name, n_rays: int, depth: int, device="cuda", seed: int = 0,
            reps: int = 5, wl: Workload = None, stats_at=()) -> dict:
    """The per-bounce A/B on one scene → summary dict. stats_at: bounce
    indices whose gate, K1 and K2 tile counts are counted too."""
    wl = wl or Workload(load_scene(scene_name), device)
    p = Pair(wl)
    on_card = wl.device.type == "cuda"
    rows = []
    for b in wl.bounces(n_rays, depth, seed):
        o, d, tm = b.o, b.d, b.t_max
        tm_s = torch.where(b.t < 1e29, b.t * 0.999, tm)
        t4, r4 = p.closest4(o, d, tm)
        t4b, r4b = p.closest4_rule(o, d, tm)
        h4, h4b = p.any4(o, d, tm_s), p.any4_rule(o, d, tm_s)
        t4_2, r4_2 = p.closest4(o, d, tm)  # a second launch: bit-equal
        h4_2 = p.any4(o, d, tm_s)
        (t_p, r_p, ent, _), plain_ms = _timed(lambda: p.closest4_plain(o, d, tm), on_card)
        (h_p, any_ent), any_plain_ms = _timed(lambda: p.any4_plain(o, d, tm_s), on_card)
        n_mis, n_bad = non_tie_mismatches(p.k1, p.prim1, b.row, p.k4, p.prim4, r4, o, d, tm)
        t1t, r1t = p.k1.closest_thread(o, d, tm)
        _, n_bad_t = non_tie_mismatches(p.k1, p.prim1, b.row, p.k1, p.prim1, r1t, o, d, tm)
        h2 = p.k1.any_hit(o, d, tm_s)
        h2t = p.k1.any_hit_thread(o, d, tm_s)
        r = {"bounce": b.index, "active": b.active, "hits": int(b.hit.sum()),
             "plain_t_bit_equal": same_bits(t4, t_p), "plain_tie_rows": int((r4 != r_p).sum()),
             "plain_any_mismatches": int((h4 != h_p).sum()),
             "rule_plain_t_bit_equal": same_bits(t4b, t_p),
             "rule_plain_tie_rows": int((r4b != r_p).sum()),
             "rule_plain_any_mismatches": int((h4b != h_p).sum()),
             "relaunch_equal": same_bits(t4, t4_2) and bool(torch.equal(r4, r4_2))
             and bool(torch.equal(h4, h4_2)),
             "dead_hits": int((r4[tm <= 0] >= 0).sum()) + int(h4[tm_s <= 0].sum()),
             "t_bit_equal": bool(torch.equal(b.t, t4)),
             "t_mismatches": int((b.t != t4).sum()),
             "prim_mismatches": n_mis, "non_tie_prim_mismatches": n_bad,
             "any_mismatches": int((h2 != h4).sum()), "any_hits": int(h2.sum()),
             "any_live": int((tm_s > 0).sum()),
             "thread_t_bit_equal": bool(torch.equal(b.t, t1t)),
             "thread_non_tie_row_mismatches": n_bad_t,
             "thread_any_mismatches": int((h2 != h2t).sum()),
             "group_tiles": int(ent.sum()), "group_any_tiles": int(any_ent.sum()),
             "max_abs_err": _t_err(t4, t_p), "rule_max_abs_err": _t_err(t4b, t_p),
             "any_max_abs_err": _h_err(h4, h_p), "rule_any_max_abs_err": _h_err(h4b, h_p),
             "gate_tiles": None, "gate_any_tiles": None, "k1_tiles": None, "k2_tiles": None,
             "plain_ms": plain_ms, "any_plain_ms": any_plain_ms,
             "k1_ms": None, "k4_ms": None, "k4_rule_ms": None, "k4_dev_ms": None,
             "k4_rule_dev_ms": None, "k2_ms": None, "k4_any_ms": None, "k4_any_rule_ms": None,
             "k4_any_dev_ms": None, "k4_any_rule_dev_ms": None,
             "k1_thread_ms": None, "k2_thread_ms": None}
        if b.index in stats_at:
            t_g, r_g, ent_g, _ = p.closest4_plain(o, d, tm, gate=True)
            h_g, any_ent_g = p.any4_plain(o, d, tm_s, gate=True)
            if not (same_bits(t_g, t_p) and torch.equal(r_g, r_p) and torch.equal(h_g, h_p)):
                raise AssertionError(f"{scene_name} bounce {b.index}: the plain version under "
                                     f"the gate differs from the group rule")
            k1 = p.k1
            _, _, ent1, _ = tri_closest_hit_tables(o, d, tm, k1.tris16, k1.caabb, k1.saabb,
                                                   k1.slab_aabb, **k1.kw, stats=True)
            _, any_ent1 = tri_any_hit_plain(o, d, tm_s, k1.tris16, k1.caabb, k1.saabb,
                                            k1.slab_aabb, **k1.kw, stats=True)
            r.update(gate_tiles=int(ent_g.sum()), gate_any_tiles=int(any_ent_g.sum()),
                     k1_tiles=int(ent1.sum()), k2_tiles=int(any_ent1.sum()))
        if on_card:
            c4 = lambda: p.closest4(o, d, tm)  # noqa: E731
            c4b = lambda: p.closest4_rule(o, d, tm)  # noqa: E731
            a4 = lambda: p.any4(o, d, tm_s)  # noqa: E731
            a4b = lambda: p.any4_rule(o, d, tm_s)  # noqa: E731
            r["k4_rule_ms"], r["k4_ms"] = turns(c4b, c4, reps)
            r["k4_rule_dev_ms"], r["k4_dev_ms"] = turns(c4b, c4, reps, device_ms)
            r["k4_any_rule_ms"], r["k4_any_ms"] = turns(a4b, a4, reps)
            r["k4_any_rule_dev_ms"], r["k4_any_dev_ms"] = turns(a4b, a4, reps, device_ms)
            r["k1_thread_ms"], r["k1_ms"] = turns(lambda: p.k1.closest_thread(o, d, tm),
                                                  lambda: p.k1.closest(o, d, tm), reps)
            r["k2_thread_ms"], r["k2_ms"] = turns(lambda: p.k1.any_hit_thread(o, d, tm_s),
                                                  lambda: p.k1.any_hit(o, d, tm_s), reps)
        rows.append(r)
    keys = ("k1_ms", "k4_ms", "k4_rule_ms", "k4_dev_ms", "k4_rule_dev_ms", "k2_ms",
            "k4_any_ms", "k4_any_rule_ms", "k4_any_dev_ms", "k4_any_rule_dev_ms",
            "k1_thread_ms", "k2_thread_ms")
    tot = {k: (sum(r[k] for r in rows) if on_card else None) for k in keys}
    return {"scene": str(scene_name), "device": str(wl.device), "rays": int(b.o.shape[0]),
            "depth": depth, "k1_tables": dict(p.k1.kw, clusters=int(p.k1.caabb.shape[0]),
                                              slabs=int(p.k1.slab_aabb.shape[0])),
            "k4_tables": dict(p.kw4, clusters=int(p.k4.caabb.shape[0]),
                              slabs=int(p.k4.slab_aabb.shape[0])),
            "bounces": rows, "totals": tot, "pair": p}


def check(s: dict) -> None:
    """Raise unless every bounce has K4 and its baseline equal to the plain
    version (t to the bit, rows exactly, any-hit), K4 launched twice equal,
    no hit on a dead lane, K4's t bit-equal to K1's with prims equal up to
    exact-t ties and any-hit equal to K2's, and the per-thread walk equal to
    K1 / K2."""
    for r in s["bounces"]:
        where = f"{s['scene']} bounce {r['bounce']}"
        if not (r["plain_t_bit_equal"] and r["rule_plain_t_bit_equal"]) or r["plain_tie_rows"] \
                or r["rule_plain_tie_rows"] or r["plain_any_mismatches"] \
                or r["rule_plain_any_mismatches"]:
            raise AssertionError(f"{where}: K4 or its baseline disagrees with the plain version "
                                 f"({r})")
        if not r["relaunch_equal"] or r["dead_hits"]:
            raise AssertionError(f"{where}: K4 differs between two launches or hit on a dead "
                                 f"lane ({r})")
        if not r["t_bit_equal"] or r["non_tie_prim_mismatches"] or r["any_mismatches"]:
            raise AssertionError(f"{where}: K4 disagrees with K1 / K2 ({r})")
        if (not r["thread_t_bit_equal"] or r["thread_non_tie_row_mismatches"]
                or r["thread_any_mismatches"]):
            raise AssertionError(f"{where}: the per-thread walk disagrees with K1 / K2 ({r})")
        if r["gate_tiles"] is not None and not (
                r["gate_tiles"] <= r["group_tiles"] and r["gate_any_tiles"] <= r["group_any_tiles"]):
            raise AssertionError(f"{where}: the gate counts more tiles than the group rule ({r})")


def report(s: dict) -> str:
    k1, k4 = s["k1_tables"], s["k4_tables"]
    lines = [f"== {s['scene']} on {s['device']}: {s['rays']} rays; K1 tables {k1['clusters']} "
             f"clusters of {k1['block_t']} in {k1['slabs']} slab(s); K4 tables {k4['clusters']} "
             f"clusters of {k4['block_t']} in {k4['slabs']} slab(s)"]
    for r in s["bounces"]:
        line = (f"  bounce {r['bounce']}: active {r['active']:>8}; K4 vs plain: t bit-equal "
                f"{r['plain_t_bit_equal']} (baseline {r['rule_plain_t_bit_equal']}), tie rows "
                f"{r['plain_tie_rows']} (baseline {r['rule_plain_tie_rows']}), any-hit "
                f"mismatches {r['plain_any_mismatches']} (baseline "
                f"{r['rule_plain_any_mismatches']}), relaunch equal {r['relaunch_equal']}; "
                f"K4 vs K1: t bit-equal {r['t_bit_equal']} (per-thread "
                f"{r['thread_t_bit_equal']}), prim mismatches {r['prim_mismatches']} "
                f"({r['non_tie_prim_mismatches']} not ties; per-thread "
                f"{r['thread_non_tie_row_mismatches']}), any-hit mismatches {r['any_mismatches']} "
                f"(per-thread {r['thread_any_mismatches']}); group-rule tiles "
                f"{r['group_tiles']} / any {r['group_any_tiles']}")
        if r["gate_tiles"] is not None:
            line += (f", gate's {r['gate_tiles']} / any {r['gate_any_tiles']}, K1's "
                     f"{r['k1_tiles']} (of {k1['block_t']} rows) / K2's {r['k2_tiles']}")
        if r["k4_ms"] is not None:
            line += (f"; closest K4 {r['k4_ms']:.4f} ms, device {r['k4_dev_ms']:.4f} (baseline "
                     f"{r['k4_rule_ms']:.4f}, device {r['k4_rule_dev_ms']:.4f}; in turns), K1 "
                     f"{r['k1_ms']:.4f} (per-thread {r['k1_thread_ms']:.4f}), plain "
                     f"{r['plain_ms']:.1f}; any K4 {r['k4_any_ms']:.4f} ms, device "
                     f"{r['k4_any_dev_ms']:.4f} (baseline {r['k4_any_rule_ms']:.4f}, device "
                     f"{r['k4_any_rule_dev_ms']:.4f}), K2 {r['k2_ms']:.4f} (per-thread "
                     f"{r['k2_thread_ms']:.4f}), plain {r['any_plain_ms']:.1f}")
        lines.append(line)
    t = s["totals"]
    if t["k1_ms"] is not None:
        lines.append(f"  totals: closest K4 {t['k4_ms']:.3f} ms, device {t['k4_dev_ms']:.3f} "
                     f"(baseline {t['k4_rule_ms']:.3f}, device {t['k4_rule_dev_ms']:.3f}), K1 "
                     f"{t['k1_ms']:.3f} (per-thread {t['k1_thread_ms']:.3f}); any K4 "
                     f"{t['k4_any_ms']:.3f} ms, device {t['k4_any_dev_ms']:.3f} (baseline "
                     f"{t['k4_any_rule_ms']:.3f}, device {t['k4_any_rule_dev_ms']:.3f}), K2 "
                     f"{t['k2_ms']:.3f} (per-thread {t['k2_thread_ms']:.3f})")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenes", nargs="*", default=["mesh10k.pbrt"])
    ap.add_argument("--rays", type=int, default=1 << 22)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    for name in args.scenes:
        s = analyze(name, args.rays, args.depth, args.device, stats_at=(0, 2))
        print(report(s), flush=True)
        check(s)


if __name__ == "__main__":
    main()
