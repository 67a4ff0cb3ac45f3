"""On the card: a short run of a render cell prints a correct result line
with the contract's keys; a cell over 2 cards, and over 4 where the host
has them, runs the port's sharded render (tests/kinds/sharded_render.py)
one rank a card, reads one card a rank, and gathers an image bit-equal to
render_plan's on one card; the same cell with one card visible exits 1
and prints nothing. Each test skips itself with fewer cards than it needs.

    python -m pytest portbench/tests/test_portbench_card.py
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench.bench import ROOT
from portbench.tests.helpers import SEED, add_cell, copy_tree


def cards(n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards, the host has {torch.cuda.device_count()}")


@pytest.fixture
def card():
    cards(1)


def run_cell(cwd, workload, trace=0, env=None):
    return subprocess.run([sys.executable, "-m", "portbench.run", "--workload", workload,
                           "--seed", str(SEED), "--seconds", "2", "--trace", str(trace)],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=900)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(card, trace):
    workload = "cornell_tex_512.render"
    res = run_cell(ROOT, workload, trace)
    assert res.returncode == 0, res.stderr[-3000:]
    result = json.loads(res.stdout.strip().splitlines()[-1])
    assert result["correct"], result["compared"]
    assert list(result)[-1] == "compared"
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["per_layer" if trace else "end_to_end"]
            if workload in m.get("workloads", [workload])}
    assert set(result["metrics"]) == want
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]


def sharded_tree(tmp_path, chips):
    """A copy with the cell mesh10k_256.sharded: mesh10k at 256², 4 spp,
    depth 8, over `chips` cards."""
    tree = copy_tree(tmp_path)
    configs = tree / "portbench" / "configs"
    cfg = json.loads((ROOT / "portbench" / "configs" / "mesh10k_1024.json").read_text())
    cfg.update(name="mesh10k_256", resolution=[256, 256], spp=4)
    (configs / "mesh10k_256.json").write_text(json.dumps(cfg))
    add_cell(tree, "sharded_render", "mesh10k_256.sharded", chips, {"kind": "sharded_render"},
             {"limits": {}}, config="mesh10k_256")
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][1], name="mesh10k_256",
                                 file="portbench/configs/mesh10k_256.json"))
    for m in bench["end_to_end"]:
        if m["name"] == "samples_per_s":
            m["workloads"].append("mesh10k_256.sharded")
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    return tree


@pytest.mark.cuda
@pytest.mark.parametrize("chips", [2, 4])
def test_a_cell_over_several_cards(tmp_path, chips):
    cards(chips)
    res = run_cell(sharded_tree(tmp_path, chips), "mesh10k_256.sharded",
                   env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert res.returncode == 0, res.stderr[-6000:]
    result = json.loads(res.stdout.strip().splitlines()[-1])
    device = result["device"]
    assert result["correct"], result["compared"]
    assert result["compared"]["px_differing_from_one_card"]["value"] == 0  # bit for bit
    assert device["platform"] == "gpu" and device["count"] == chips
    assert [r["rank"] for r in device["ranks"]] == [r["index"] for r in device["ranks"]] == list(
        range(chips))
    assert len({r["uuid"] for r in device["ranks"]}) == chips
    assert all(r["peak_bytes"] > 0 for r in device["ranks"])
    assert device["memory_peak_bytes"] == max(r["peak_bytes"] for r in device["ranks"])
    assert {"samples_per_s", "peak_gib", "setup_s"} == set(result["metrics"])


@pytest.mark.cuda
def test_one_card_visible_for_a_cell_of_two(tmp_path):
    cards(1)
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="0")
    res = run_cell(sharded_tree(tmp_path, 2), "mesh10k_256.sharded", env=env)
    assert res.returncode == 1
    assert res.stdout == ""
