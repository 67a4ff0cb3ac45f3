"""The rank runner (portbench/ranks.py) on the CPU: two gloo rank processes
run a probe kind (tests/kinds/probe.py) in a copy of the benchmark. Every
rank runs the units that rank 0's clock allows; the result line is a
one-card run's with `device.ranks`; each compared number is the worst over
the ranks; a rank that fails or hangs ends the run with exit 1 and no
result; ranks that share a card, and a kind that runs on one card only,
are refused."""

import json
import os
import subprocess
import sys
import time

import pytest

from portbench import ranks
from portbench.bench import ROOT
from portbench.tests.helpers import SEED, add_cell, copy_tree, tiny_cell

SECONDS = 0.4
ALLOWANCE_S = 8.0  # the hang test's deadline is SECONDS + this


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tree = copy_tree(tmp_path_factory.mktemp("probe"))
    for fault in ("none", "raises", "hangs", "breaks", "shares_a_card"):
        for chips in (1, 2):
            add_cell(tree, "probe", f"probe.{fault}.{chips}", chips,
                     {"kind": "probe", "fault": fault}, {"limits": {"gap": 0.1}})
    return tree


def run(tree, workload, trace=0):
    """The cell through run.py's path past its look for a card: measure in
    this process at one card, ranks.launch at several → (exit code,
    stdout, stderr, seconds)."""
    call = (f"ranks.launch(cell, {SEED}, {SECONDS}, {bool(trace)}, time.perf_counter(), 'cpu', "
            f"{ALLOWANCE_S})")
    code = (
        "import json, sys, time\n"
        "from portbench import ranks\n"
        "from portbench.bench import load_cell, measure\n"
        f"cell = load_cell({workload!r})\n"
        "if cell.chips > 1:\n"
        f"    sys.exit({call})\n"
        f"result, _ = measure(cell, {SEED}, {SECONDS}, {bool(trace)}, 'cpu')\n"
        "print(json.dumps(result))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tree), str(ROOT)]), OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    res = subprocess.run([sys.executable, "-c", code], cwd=tree, env=env, capture_output=True,
                         text=True, timeout=120)
    return res.returncode, res.stdout, res.stderr, time.monotonic() - t0


def last_line(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_every_rank_runs_the_same_units(tree, trace):
    for r in (0, 1):
        (tree / f"units.{r}").unlink(missing_ok=True)
    rc, out, err, _ = run(tree, "probe.none.1", trace)
    assert rc == 0, err[-3000:]
    one = last_line(out)
    rc, out, err, _ = run(tree, "probe.none.2", trace)
    assert rc == 0, err[-3000:]
    two = last_line(out)
    units = [int((tree / f"units.{r}").read_text()) for r in (0, 1)]
    # rank 1 sleeps twice as long a unit: left to itself, rank 0 would run more
    assert units == [two["attempted"]] * 2 and two["attempted"] >= 2
    assert two["correct"] and two["failed"] == 0
    assert list(two) == list(one) and list(two)[-1] == "compared"
    assert set(two["device"]) == set(one["device"]) | {"ranks"}
    assert one["device"]["count"] == 1 and two["device"]["count"] == 2
    assert [(r["rank"], r["uuid"], r["peak_bytes"]) for r in two["device"]["ranks"]] == [
        (0, "probe-card-0", 1000), (1, "probe-card-1", 2000)]
    assert two["device"]["memory_peak_bytes"] == 2000  # the fullest card's
    assert set(two["metrics"]) == set(one["metrics"])
    if trace:
        # busy: the cards' mean; window: rank 0's; operations summed over the cards
        assert two["device"]["busy_s"] == pytest.approx((0.015 + 0.025) / 2)
        assert two["device"]["window_s"] == pytest.approx(0.05)
        assert [r["busy_s"] for r in two["device"]["ranks"]] == pytest.approx([0.015, 0.025])
        assert dict(map(tuple, two["breakdown"]["device_ops"])) == pytest.approx(
            {"all_reduce": 0.03, "op_of_rank_0": 0.005, "op_of_rank_1": 0.005})
    else:
        assert two["metrics"]["peak_gib"]["value"] == 2000 / 2**30


def test_the_worst_rank_decides(tree):
    rc, out, err, _ = run(tree, "probe.breaks.2")
    assert rc == 0, err[-3000:]
    result = last_line(out)
    assert not result["correct"]
    assert result["compared"]["gap"] == {"value": 0.5, "limit": 0.1}  # rank 1's, not rank 0's
    assert "compared gap 0.5 limit 0.1" in err.strip().splitlines()[-1]


@pytest.mark.parametrize("fault, says", [
    ("raises", "the probe's rank 1 fails in its third unit"),
    ("hangs", f"ranks still ran {SECONDS + ALLOWANCE_S:g} s after they started"),
    ("shares_a_card", "ranks share a card (probe-card-0)"),
])
def test_a_broken_rank_ends_the_run(tree, fault, says):
    rc, out, err, seconds = run(tree, f"probe.{fault}.2")
    assert rc == 1 and out == ""
    assert says in err
    if fault == "hangs":
        assert SECONDS + ALLOWANCE_S <= seconds < SECONDS + ALLOWANCE_S + 30


def test_a_one_card_kind_is_refused(monkeypatch, capsys):
    cell = tiny_cell("cornell_tex_512.render")
    cell.chips = 2

    def no_rank(*a, **kw):
        raise AssertionError("a rank was started")

    monkeypatch.setattr(ranks.subprocess, "Popen", no_rank)
    assert ranks.launch(cell, SEED, SECONDS, False, time.perf_counter(), "cpu") == 1
    out, err = capsys.readouterr()
    assert out == "" and "it does not set RANKS" in err
