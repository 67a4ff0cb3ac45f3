"""What the benchmark's tests share: cells of BENCHMARK.json cut to a size
the CPU renders in seconds, and a copy of the benchmark's files."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.bench import HERE, ROOT, load_cell

# (width, height, spp, depth) of each configuration on the CPU
TINY = {"cornell_tex_512": (16, 16, 4, 3), "mesh10k_1024": (12, 12, 2, 3)}
SEED = 2**31 + 977  # a seed above 32 signed bits, as a benchmark run may be given


def tiny_cell(workload: str):
    """The cell as BENCHMARK.json has it, its configuration cut to TINY."""
    cell = load_cell(workload)
    w, h, spp, depth = TINY[cell.config["name"]]
    cell.config = dict(cell.config, resolution=[w, h], spp=spp, max_depth=depth)
    return cell


def copy_tree(dest: Path) -> Path:
    """BENCHMARK.json and the benchmark's files (no tests, no caches) under
    dest, their configurations cut to TINY."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(HERE, dest / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for name, (w, h, spp, depth) in TINY.items():
        path = dest / "portbench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(resolution=[w, h], spp=spp, max_depth=depth)
        path.write_text(json.dumps(cfg))
    return dest


def add_cell(tree: Path, kind: str, name: str, chips: int, traffic: dict, check: dict,
             config: str = "cornell_tex_512") -> None:
    """A cell `name` of the configuration `config` added to a copy_tree copy:
    the test kind tests/kinds/<kind>.py as the copy's kinds/<kind>.py, a
    traffic mix and a check of the cell's own, and its entry in the copy's
    BENCHMARK.json."""
    pb = tree / "portbench"
    shutil.copy(HERE / "tests" / "kinds" / f"{kind}.py", pb / "kinds" / f"{kind}.py")
    (pb / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    (pb / "checks" / f"{name}.json").write_text(json.dumps(check))
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    bench["workloads"] = [w for w in bench["workloads"] if w["name"] != name] + [
        {"name": name, "config": config, "traffic": name, "chips": chips, "why": "a test"}]
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
