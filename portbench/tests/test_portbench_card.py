"""On the card: a short run of each render cell prints a correct result
line with the contract's keys. Skips without a card.

    python -m pytest portbench/tests/test_portbench_card.py
"""

import json
import subprocess
import sys

import pytest
import torch

from portbench.bench import ROOT
from portbench.tests.helpers import SEED


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(card, trace):
    res = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "cornell_tex_512.render", "--seed", str(SEED), "--seconds", "2",
                          "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    result = json.loads(res.stdout.strip().splitlines()[-1])
    assert result["correct"], result["compared"]
    assert list(result)[-1] == "compared"
    assert result["device"]["platform"] == "gpu"
    want = {"idle_pct.render", "torch_ms.render", "traversal_roofline_pct.render", "plan_s"}
    assert set(result["metrics"]) == (want if trace else {"samples_per_s", "peak_gib", "setup_s"})
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
