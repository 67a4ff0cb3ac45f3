"""A kind for the rank runner's CPU tests, copied into a copy's kinds/.
Each unit all-reduces over the default group, then sleeps for a time that
differs from rank to rank and from unit to unit, so that the ranks end
their units at different times. The CPU has no card: each rank stands in
a card of its own for the harness's device report (bench.card_report).
The traffic's "fault" breaks rank 1: "raises" (in its third unit),
"hangs" (sleeps in its third unit), "breaks" (its compared number is over
the limit), "shares_a_card" (every rank stands in card 0); "none" is a
sound run. Each rank writes the units it ran to units.<rank> in the
checkout."""

import time

import torch
import torch.distributed as dist

from portbench import bench

RANKS = True


def setup(cell, seed, dev, rec):
    rank, fault = rec["rank"], cell.traffic["fault"]
    card = 0 if fault == "shares_a_card" else rank
    bench.card_report = lambda device: {"index": card, "uuid": f"probe-card-{card}",
                                        "peak_bytes": 1000 * (rank + 1)}
    return {"rank": rank, "world": rec["world"], "fault": fault, "units": 0}


def unit(state) -> bool:
    state["units"] += 1
    if state["world"] > 1:
        x = torch.ones(1)
        dist.all_reduce(x)
        assert x.item() == state["world"]
    if state["rank"] == 1 and state["units"] == 3:
        if state["fault"] == "raises":
            raise RuntimeError("the probe's rank 1 fails in its third unit")
        if state["fault"] == "hangs":
            time.sleep(3600)
    # rank 1 ends each unit 30-90 ms after rank 0, so that, were each rank to
    # read its own clock, rank 1 would nearly always close its window a unit early
    time.sleep(0.002 if state["rank"] == 0 else 0.03 * state["rank"] * (1 + state["units"] % 3))
    return True


def work(state, units: int) -> dict:
    return {"samples": 1000 * units}


def trace(state, rec):
    r = state["rank"]
    rec["trace"] = {"records": [("all_reduce", 1e4 * (1 + r)), (f"op_of_rank_{r}", 5e3)],
                    "busy_s": 0.01 * (1 + r) + 0.005, "window_s": 0.05 + 0.01 * r, "units": 1}
    return {"device_ops": [], "idle_gaps": []}


def check(state, cell, seed) -> dict:
    (bench.ROOT / f"units.{state['rank']}").write_text(str(state["units"]))
    broken = state["fault"] == "breaks" and state["rank"] == 1
    return {"gap": (0.5 if broken else 0.001 * (1 + state["rank"]), cell.check["limits"]["gap"])}
