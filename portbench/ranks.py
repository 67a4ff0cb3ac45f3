"""A cell over several cards: one rank process a card, one window agreed
by all, and a device report read from the cards that the ranks used.

The parent, `python -m portbench.run` at a cell's `chips` > 1, calls
`launch`: it starts one rank process a card (`python -m portbench.ranks`),
waits for them, and prints the result that rank 0 assembled. It makes no
CUDA context and allocates nothing.

Each rank pins itself to its card (torch.cuda.set_device(rank), before any
allocation), joins the default NCCL group on 127.0.0.1 (gloo on the CPU)
so that the program's `parallel.mesh.make_mesh()` finds it, and opens a
gloo side group for the harness's own messages, so that no card's trace
holds them. Then it runs `bench.measure` with its `Team`: after every
rank's set-up the ranks meet at a barrier and the window opens; after each
unit rank 0 decides whether the window has ended and the others follow, so
every rank runs the same units; after the check each rank's card, peak,
units, numbers and trace are gathered to rank 0, which writes the result.

A kind runs at several ranks only where it says so (`RANKS = True`); its
`setup` finds `rec["rank"]` and `rec["world"]`. The result's `work` is
rank 0's (a kind counts the whole job once), each compared number is the
worst over the ranks, and `correct` needs every rank's check to pass.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

from portbench.bench import ROOT, device_fault, forbidden_modules, load_cell, load_module, measure
from portbench.trace import op_seconds, top_ops

# Seconds a rank run may go on beyond --seconds before every rank is killed.
# The contract gives a run 360 s to exit. At the benchmark's 45 s window
# this leaves the parent 15 s of its own; set-up has taken 9-52 s on one
# card (imports, the card's start, the kernels' build, the warm-up), the
# check's reference up to about a minute, and NCCL's start a few seconds.
ALLOWANCE_S = 300.0
TAIL = 2000  # characters of each rank's standard error that the parent passes on


@dataclass
class Team:
    """This rank's place among the ranks, and the gloo side group that
    carries the harness's own messages."""

    rank: int
    world: int
    side: object

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.side)

    def agree(self, over: bool, ok: bool):
        """→ (rank 0's `over`, whether the unit held on every rank)."""
        import torch
        import torch.distributed as dist

        flags = torch.tensor([int(over and self.rank == 0), int(not ok)])
        dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=self.side)
        return bool(flags[0]), not bool(flags[1])

    def merge(self, rec: dict, card, units: int, numbers: dict, trace: bool):
        """Gathers every rank's card, units, numbers and trace to rank 0 →
        on rank 0 (the worst of each number over the ranks, the cards, the
        device operations summed over the cards), with rec made the whole
        run's (see `merge_reports`); None on the others."""
        import torch.distributed as dist

        mine = {"rank": self.rank, "card": card, "units": units, "numbers": numbers}
        if trace:
            t = rec["trace"]
            mine.update(busy_s=t["busy_s"], window_s=t["window_s"], ops=op_seconds(t["records"]))
        reports = [None] * self.world
        dist.all_gather_object(reports, mine, group=self.side)
        return merge_reports(rec, reports, trace) if self.rank == 0 else None


def merge_reports(rec: dict, reports: list, trace: bool):
    """Rank 0's rec made the run's, from every rank's report (in rank
    order): `peak_bytes` the fullest card's, `ranks` each rank's card and
    peak (with --trace 1 its busy and window seconds), and the trace's
    `busy_s` the mean over the cards (its `window_s` stays rank 0's). →
    (each number's worst value over the ranks with its limit, the cards,
    with --trace 1 the 10 device operations that took most time summed over
    the cards). Raises where the ranks ran different numbers of units or
    compared different numbers."""
    if len({r["units"] for r in reports}) != 1:
        raise RuntimeError(f"the ranks ran different numbers of units: "
                           f"{[r['units'] for r in reports]}")
    names = {frozenset(r["numbers"]) for r in reports}
    if len(names) != 1:
        raise RuntimeError(f"the ranks compared different numbers: {sorted(map(sorted, names))}")
    cards = [r["card"] for r in reports]
    rec["ranks"] = []
    for r, card in zip(reports, cards):
        entry = {"rank": r["rank"], **(card or {"index": None, "uuid": None, "peak_bytes": 0})}
        if trace:
            entry.update(busy_s=r["busy_s"], window_s=r["window_s"])
        rec["ranks"].append(entry)
    rec["peak_bytes"] = max(e["peak_bytes"] for e in rec["ranks"])
    numbers = {}
    for name, (_, limit) in reports[0]["numbers"].items():
        values = [r["numbers"][name][0] for r in reports]
        failing = [v for v in values if not v <= limit]  # NaN fails too
        numbers[name] = (failing[0] if failing else max(values), limit)
    ops = None
    if trace:
        rec["trace"]["busy_s"] = sum(r["busy_s"] for r in reports) / len(reports)
        summed = {}
        for r in reports:
            for name, s in r["ops"].items():
                summed[name] = summed.get(name, 0.0) + s
        ops = top_ops(summed)
    return numbers, cards, ops


# ---------------------------------------------------------------------------
# the parent


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stop(procs) -> None:
    """Kills every rank's process group (a rank and what it started, such
    as a kernel build) and waits for each rank."""
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:  # the group has ended
            pass
        p.wait()


def launch(cell, seed: int, seconds: float, trace: bool, t_start: float, device: str = "cuda",
           allowance_s: float = ALLOWANCE_S) -> int:
    """Runs `cell` with one rank process a card (`device` "cpu" runs gloo
    ranks, for the tests) and prints its result line → the exit code. Exits
    1 with no result where the cell's kind does not run at several ranks,
    a rank fails, the ranks are still running `seconds` + `allowance_s`
    after their start, or the ranks did not use one card each."""
    kind = load_module("kinds", cell.traffic["kind"])
    if not getattr(kind, "RANKS", False):
        print(f"portbench: {cell.name} asks for {cell.chips} cards, but its kind "
              f"{cell.traffic['kind']!r} runs on one card only (it does not set RANKS)",
              file=sys.stderr)
        return 1
    port, limit = free_port(), seconds + allowance_s
    with tempfile.TemporaryDirectory(prefix="portbench-ranks-") as tmp:
        tmp = Path(tmp)
        procs, fault = [], None
        try:
            for r in range(cell.chips):
                with open(tmp / f"rank{r}.out", "w") as out, open(tmp / f"rank{r}.err", "w") as err:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "portbench.ranks", "--workload", cell.name,
                         "--seed", str(seed), "--seconds", repr(seconds), "--trace", str(int(trace)),
                         "--t-start", repr(t_start), "--rank", str(r), "--world", str(cell.chips),
                         "--port", str(port), "--device", device, "--result", str(tmp / "result.json")],
                        cwd=ROOT, stdout=out, stderr=err, start_new_session=True))
            deadline = time.monotonic() + limit
            while fault is None:
                codes = [p.poll() for p in procs]
                bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    fault = "; ".join(f"rank {r} exited with {c}" for r, c in bad)
                elif all(c == 0 for c in codes):
                    break
                elif time.monotonic() > deadline:
                    fault = f"ranks still ran {limit:g} s after they started (killed)"
                else:
                    time.sleep(0.05)
        finally:
            _stop(procs)
        tails = [(tmp / f"rank{r}.err").read_text()[-TAIL:] for r in range(len(procs))]
        result = None
        if fault is None:
            result = json.loads((tmp / "result.json").read_text())
            fault = device_fault(result["device"], cell.chips)
    for r, tail in enumerate(tails):
        if tail.strip():
            print(f"--- rank {r}, the end of its standard error:\n{tail}", file=sys.stderr)
    bad = forbidden_modules()
    if fault is None and bad:
        fault = (f"the process loaded {bad}: the port's benchmark may load neither JAX nor the "
                 f"JAX package")
    if fault is not None:
        print(f"portbench: {cell.name}: {fault}", file=sys.stderr)
        return 1
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


# ---------------------------------------------------------------------------
# a rank


def rank_main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One rank of a cell (started by portbench.ranks.launch).")
    for name, typ in (("--workload", str), ("--seed", int), ("--seconds", float),
                      ("--trace", int), ("--t-start", float), ("--rank", int), ("--world", int),
                      ("--port", int), ("--device", str), ("--result", Path)):
        ap.add_argument(name, type=typ, required=True)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    cell = load_cell(args.workload)
    init = {"init_method": f"tcp://127.0.0.1:{args.port}", "world_size": args.world,
            "rank": args.rank}
    if args.device == "cuda":
        torch.cuda.set_device(args.rank)  # this rank's card, before anything is allocated
        device = f"cuda:{args.rank}"
        dist.init_process_group("nccl", device_id=torch.device(device), **init)
    else:
        device = "cpu"
        dist.init_process_group("gloo", **init)
    try:
        team = Team(args.rank, args.world, dist.new_group(backend="gloo"))
        result, _ = measure(cell, args.seed, args.seconds, bool(args.trace), device, args.t_start,
                            team)
    except Exception:
        # out at once, leaving the groups as they are: the other ranks may wait in a
        # collective that this rank will not join, and the parent kills them
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: rank {args.rank} loaded {bad}: the port's benchmark may load "
              f"neither JAX nor the JAX package", file=sys.stderr)
        return 1
    if result is not None:
        args.result.write_text(json.dumps(result))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(rank_main())
