"""The port's scaling tool (curry_pbrt_tpu_torch/tools/scaling_bench.py) on
the CPU, mirroring tests/test_scaling.py: cornell.pbrt at 32², 2 spp, depth
2 at one and two gloo ranks. Its JSON line carries the regime, the
workload and, per world size, the walls, camera rays per second and the
overhead proxy wall_1 / wall_N, and no scaling efficiency (the ranks share
the host's cores); the two images agree within atol 1e-6, the multihost
test's tolerance (the JAX scaling test's 1e-7 is for one process, where
only XLA's fusion differs; torch's vectorised CPU kernels may round the
scalar tail of a slab of another length an ULP apart).

The JAX test's bounds on the proxy (wall_1 / wall_8 >= 0.65, and at most
2.0 s added) are not carried here. JAX measures shard_map inside one
process; here each world size is a set of processes that start, import
torch and plan the scene, while the tier-1 run's five other xdist workers
share the same cores, so the walls measure the host's load as much as the
sharding. The tool reports the proxy; the test checks what it reports.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    out = tmp_path_factory.mktemp("scaling")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "curry_pbrt_tpu_torch.tools.scaling_bench", "--scene",
         "cornell.pbrt", "--res", "32", "--spp", "2", "--depth", "2", "--ranks", "1", "2",
         "--passes", "2", "--device", "cpu", "--out", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1]), out


def test_scaling_line_has_the_keys_and_the_regime(report):
    line, _ = report
    assert line["regime"] == "ranks sharing the host's cores"
    assert line["device"] == "cpu" and line["card"] == "cpu"
    assert line["workload"] == {"scene": "cornell.pbrt", "res": 32, "spp": 2, "depth": 2,
                                "camera_rays": 32 * 32 * 2, "passes": 2}
    assert set(line["ranks"]) == {"1", "2"}
    for n, r in line["ranks"].items():
        assert r["backend"] == "gloo" and len(r["walls_s"]) == 2
        assert r["wall_s"] > 0 and r["rays_per_sec"] == pytest.approx(2048 / r["wall_s"])
        assert r["scaling_efficiency"] is None
        assert r["wall_1_over_wall_n"] == pytest.approx(line["ranks"]["1"]["wall_s"] / r["wall_s"])


def test_scaling_images_agree_across_world_sizes(report):
    line, out = report
    one, two = np.load(out / "image_1.npy"), np.load(out / "image_2.npy")
    assert one.shape == (32 * 32, 3) and np.isfinite(one).all() and one.mean() > 0
    np.testing.assert_allclose(two, one, atol=1e-6)
    assert line["ranks"]["2"]["max_abs_diff_vs_first"] <= 1e-6
