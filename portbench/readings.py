"""The readings that the check's limits are set from: for each seed, the
program's set-up and one unit of the window's work, its answers (the
pass's image and segments, or the checked steps) held against the
reference; for the control seeds, the
reference in the program's place with its ray state in bfloat16; for the
fault seeds, each fault the cell's kind reads on the card. One process,
one cell; the benchmark's own runs never run this.

    python -m portbench.readings --workload <cell> --seeds 1 2 ... \\
        [--control-seeds 1 2 3] [--fault-seeds 1 2 3] [--out readings.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)

    import torch

    from portbench.bench import load_cell, load_module
    from portbench.ref.render import bf16_store

    cell = load_cell(args.workload)
    kind = load_module("kinds", cell.traffic["kind"])
    dev = torch.device("cuda")
    rows = []

    def plain(numbers):
        return {k: v for k, (v, _) in numbers.items()}

    for seed in sorted(set(args.seeds) | set(args.control_seeds) | set(args.fault_seeds)):
        row = {"seed": seed}
        t0 = time.perf_counter()
        ref = kind.reference(cell, seed, dev)
        row["reference_s"] = time.perf_counter() - t0
        if seed in args.seeds:
            t0 = time.perf_counter()
            state = kind.setup(cell, seed, dev, {})
            kind.unit(state)  # one unit of the window's work
            row["program_s"] = time.perf_counter() - t0
            row["program"] = plain(kind.compare(kind.answers(state), ref, cell.check))
            state.clear()
            torch.cuda.empty_cache()
        if seed in args.control_seeds:
            t0 = time.perf_counter()
            row["control"] = plain(kind.compare(kind.control(cell, seed, dev, bf16_store), ref,
                                                cell.check))
            row["control_s"] = time.perf_counter() - t0
        if seed in args.fault_seeds:
            row["faults"] = {name: plain(kind.compare(prog, ref, cell.check))
                             for name, prog in kind.faults(cell, seed, dev).items()}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"workload": cell.name, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
