"""Run one cell of the port's benchmark: on one card in this process, or,
where the cell asks for several, one rank process a card (portbench/ranks.py).

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
--trace 0, its per-layer metrics with --trace 1), `device`, with --trace 1
`breakdown`, and last `compared`: each number the check compared, with its
limit. The same numbers close standard error. Exits 1, with no result,
without a usable card, when the run used other cards than the cell asks for
(`device.count` is read from the cards' UUIDs), when the process has loaded
JAX or the JAX package, or when the run fails.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.bench import device_fault, forbidden_modules, load_cell, measure

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is False: no card, no run", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, this process sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    if cell.chips > 1:
        from portbench.ranks import launch

        return launch(cell, args.seed, args.seconds, bool(args.trace), T_START)
    torch.cuda.set_device(0)
    result, numbers = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {bad}: the port's benchmark may load neither "
              f"JAX nor the JAX package", file=sys.stderr)
        return 1
    fault = device_fault(result["device"], cell.chips)
    if fault:
        print(f"portbench: {cell.name}: {fault}", file=sys.stderr)
        return 1
    for name, (value, limit) in numbers.items():
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
