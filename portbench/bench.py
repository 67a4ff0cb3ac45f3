"""One run of one cell: set-up, the measured window, the trace, the check
against the plain reference, and the result line.

Everything a cell is made of is found by name under this folder, from its
entry in BENCHMARK.json: configs/<config>.json, traffic/<traffic>.json,
checks/<cell>.json, kinds/<the traffic's kind>.py and metrics/<metric>.py.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that may not be loaded in a measuring process: the
# JAX package and JAX itself (compared whole: the port's name begins with
# the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "curry_pbrt_tpu")


def load_module(folder: str, name: str):
    """The module in <folder>/<name>.py under this folder, by its path (a
    name may hold dots)."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"portbench.{folder}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(folder: str, name: str) -> dict:
    path = HERE / folder / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} file for {name!r}: {path}")
    return json.loads(path.read_text())


@dataclass
class Metric:
    name: str
    unit: str
    reader: object  # a module with read(rec) → number or None


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list = field(default_factory=list)  # [Metric] of a --trace 0 run
    per_layer: list = field(default_factory=list)  # [Metric] of a --trace 1 run

    @property
    def scene_path(self) -> Path:
        return ROOT / self.config["scene"]

    def overrides(self, seed: int) -> dict:
        """The compile overrides of the configuration at `seed` (the
        sampler's scramble seed takes 32 bits)."""
        c = self.config
        return {"resolution": tuple(c["resolution"]), "spp": c["spp"],
                "max_depth": c["max_depth"], "integrator": c["integrator"],
                "filter": c["filter"], "seed": int(seed) % 2**32}


def load_cell(workload: str, benchmark: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell named `workload` in BENCHMARK.json, with its files."""
    bench = json.loads(benchmark.read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {workload!r}")

    def metrics(specs):
        out = []
        for spec in specs:
            if workload not in spec.get("workloads", [workload]):
                continue
            reader = load_module("metrics", spec["name"])
            if reader.UNIT != spec["unit"]:
                raise ValueError(f"metric {spec['name']}: its reader's unit {reader.UNIT!r} "
                                 f"is not BENCHMARK.json's {spec['unit']!r}")
            out.append(Metric(spec["name"], spec["unit"], reader))
        return out

    return Cell(name=workload, chips=entry["chips"], config=_json("configs", entry["config"]),
                traffic=_json("traffic", entry["traffic"]), check=_json("checks", workload),
                end_to_end=metrics(bench["end_to_end"]), per_layer=metrics(bench["per_layer"]))


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def card_report(device):
    """The card that `device` names, as the card itself reports it: its
    index, its UUID, and the bytes allocated on it at the peak since
    reset_peak_memory_stats. None off a card."""
    import torch

    if device.type != "cuda":
        return None
    index = torch.cuda.current_device() if device.index is None else device.index
    return {"index": index, "uuid": str(torch.cuda.get_device_properties(index).uuid),
            "peak_bytes": torch.cuda.max_memory_allocated(index)}


def cards_used(cards) -> int:
    """The number of distinct cards (by UUID) on which some rank allocated
    memory: `device.count`, read from the cards, never from the cell."""
    return len({c["uuid"] for c in cards if c is not None and c["peak_bytes"] > 0})


def device_fault(device: dict, chips: int):
    """Why a result's device report does not show the cell's `chips` cards
    in use, one rank a card; None where it does."""
    uuids = [r["uuid"] for r in device.get("ranks", []) if r["uuid"] is not None]
    shared = sorted({u for u in uuids if uuids.count(u) > 1})
    if shared:
        return f"ranks share a card ({', '.join(shared)}): one rank a card"
    if device["count"] != chips:
        return f"the run used {device['count']} card(s); the cell asks for {chips}"
    return None


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
            t_start: float = None, team=None):
    """One run → (result dict, the numbers compared: {name: (value, limit)}).
    t_start: the process's start on time.perf_counter (set-up runs from it).
    team: this rank's portbench.ranks.Team where the cell runs over several
    ranks; every rank measures, and rank 0 alone gets the result ((None,
    None) on the others)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    kind = load_module("kinds", cell.traffic["kind"])
    rec = {"card": card_name(dev), "package_dir": ROOT / "curry_pbrt_tpu_torch",
           "rank": team.rank if team else 0, "world": team.world if team else 1}
    t_kind = time.perf_counter()
    state = kind.setup(cell, seed, dev, rec)
    if on_card:
        torch.cuda.synchronize(dev)
    if team:
        team.barrier()  # the window opens on every rank at once
    t0 = time.perf_counter()
    rec["setup_s"] = t0 - t_start
    # where set-up went: to the card (imports, its start), compile + plan, the rest
    rec["setup_parts"] = {"to_card_s": t_kind - t_start, "plan_s": rec.get("plan_s"),
                          "warm_up_s": t0 - t_kind - rec.get("plan_s", 0.0)}
    units = failed = 0
    while True:
        units += 1
        ok = kind.unit(state)
        over = time.perf_counter() - t0 >= seconds
        if team:
            over, ok = team.agree(over, ok)  # rank 0's clock ends the window for all
        failed += 0 if ok else 1
        if over:
            break
    if on_card:
        torch.cuda.synchronize(dev)
    rec["window_s"] = time.perf_counter() - t0
    rec["units"] = units
    rec.update(kind.work(state, units))
    card = card_report(dev)
    rec["peak_bytes"] = card["peak_bytes"] if card else 0
    breakdown = kind.trace(state, rec) if trace else None
    numbers = kind.check(state, cell, seed)
    cards = [card]
    if team:
        merged = team.merge(rec, card, units, numbers, trace)
        if merged is None:
            return None, None
        numbers, cards, ops = merged
        if trace:
            breakdown = dict(breakdown, device_ops=ops)
    result = {
        "correct": failed == 0 and all(v <= lim for v, lim in numbers.values()),
        "attempted": units,
        "failed": failed,
        "metrics": {},
        "device": {"platform": "gpu" if on_card else "cpu", "kind": rec["card"],
                   "count": cards_used(cards), "memory_peak_bytes": rec["peak_bytes"]},
    }
    if team:
        result["device"]["ranks"] = rec["ranks"]
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.reader.read(rec)
        if value is not None:
            if not math.isfinite(value):
                raise ValueError(f"metric {m.name} read {value}")
            result["metrics"][m.name] = {"value": value, "unit": m.unit}
    if trace:
        result["device"].update(busy_s=rec["trace"]["busy_s"], window_s=rec["trace"]["window_s"])
        result["breakdown"] = breakdown
    result["setup_parts"] = rec["setup_parts"]
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    return result, numbers
