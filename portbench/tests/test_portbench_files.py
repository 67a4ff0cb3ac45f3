"""The harness finds cells, configurations, traffic mixes and metrics by
name, as files; without a card it prints no result; and nothing a cell
runs loads JAX, the JAX package or the repository's other benches and
tools."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.bench import ROOT
from portbench.tests.helpers import SEED, copy_tree


def _python(code: str, cwd: Path, path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(str(p) for p in path))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a metric and a check dropped into a
    copy, and named in its BENCHMARK.json, run with no other edit."""
    tree = copy_tree(tmp_path)
    pb = tree / "portbench"
    cfg = json.loads((pb / "configs" / "cornell_tex_512.json").read_text())
    cfg.update(name="cornell_small", resolution=[8, 8], spp=2, max_depth=2)
    (pb / "configs" / "cornell_small.json").write_text(json.dumps(cfg))
    shutil.copy(pb / "traffic" / "render.json", pb / "traffic" / "render_again.json")
    shutil.copy(pb / "checks" / "cornell_tex_512.render.json",
                pb / "checks" / "cornell_small.render_again.json")
    (pb / "metrics" / "passes_per_s.py").write_text(
        'UNIT = "passes/s"\n\n\ndef read(rec):\n    return rec["units"] / rec["window_s"]\n')
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="cornell_small",
                                 file="portbench/configs/cornell_small.json"))
    bench["workloads"].append({"name": "cornell_small.render_again", "config": "cornell_small",
                               "traffic": "render_again", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "passes_per_s", "unit": "passes/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["cornell_small.render_again"]})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    res = _python(
        "import json\n"
        "from portbench.bench import load_cell, measure\n"
        f"result, _ = measure(load_cell('cornell_small.render_again'), {SEED}, 0.0, False, 'cpu')\n"
        "print(json.dumps(result))\n", tree, [tree, ROOT])
    assert res.returncode == 0, res.stderr[-3000:]
    result = json.loads(res.stdout.strip().splitlines()[-1])
    assert result["correct"]
    # samples_per_s names its cells; setup_s, with no list, is every cell's
    assert set(result["metrics"]) == {"passes_per_s", "setup_s"}
    assert result["metrics"]["passes_per_s"]["unit"] == "passes/s"


@pytest.mark.parametrize("with_program", [True, False])
def test_no_card_no_result(tmp_path, with_program):
    """Without a usable card the run exits 1 and prints nothing on
    standard output; so it does in a directory that holds only
    BENCHMARK.json and the benchmark's files."""
    tree = copy_tree(tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    if with_program:
        env["PYTHONPATH"] = os.pathsep.join([str(tree), str(ROOT)])
    else:
        env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "cornell_tex_512.render", "--seed", str(SEED), "--seconds", "1",
                          "--trace", "0"], cwd=tree, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert res.stdout == ""


def test_a_cell_loads_no_jax_and_no_other_bench(tmp_path):
    """Every cell of BENCHMARK.json, run at a CPU's size in a fresh
    interpreter, leaves no module whose top-level name is jax, jaxlib,
    flax or curry_pbrt_tpu (compared whole: the port's name begins with
    the JAX package's), and none loaded from the root bench.py, the root
    tools/, chip_smoke.py or the port's bench.py and tools/."""
    res = _python(
        "import json, sys\n"
        "from portbench import run\n"
        "from portbench.bench import forbidden_modules, measure\n"
        "from portbench.tests.helpers import tiny_cell\n"
        "bench = json.load(open('BENCHMARK.json'))\n"
        "for w in bench['workloads']:\n"
        f"    result, _ = measure(tiny_cell(w['name']), {SEED}, 0.0, False, 'cpu')\n"
        "    assert result['correct'], (w['name'], result)\n"
        "print(json.dumps({'forbidden': forbidden_modules(), 'files': sorted(\n"
        "    str(getattr(m, '__file__', None) or '') for m in list(sys.modules.values()))}))\n",
        ROOT, [ROOT])
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == []
    port = ROOT / "curry_pbrt_tpu_torch"
    banned = [ROOT / "bench.py", ROOT / "chip_smoke.py", port / "bench.py"]
    banned_dirs = [ROOT / "tools", port / "tools"]
    loaded = [Path(f) for f in out["files"] if f]
    assert not [f for f in loaded if f in banned or any(d in f.parents for d in banned_dirs)]
    assert any(port in f.parents for f in loaded)  # the cells did run the port
