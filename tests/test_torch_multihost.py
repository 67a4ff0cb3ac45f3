"""Multi-process rendering in the PyTorch port
(curry_pbrt_tpu_torch/parallel/multihost.py), mirroring
tests/test_multihost.py: two rank processes over a gloo group on the CPU
render cornell.pbrt at 32², 2 spp, depth 2 through render_distributed; both
hold the same image, equal to each other, and it matches the single-process
render_distributed within atol 1e-6 (tests/test_multihost.py:74). The rank
processes import no JAX. render_distributed refuses a tent-filter scene at
more than one process, and the CLI's default device, cuda, raises without a
card.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from curry_pbrt_tpu_torch.parallel.multihost import main, render_distributed, run_ranks
from tests.test_render_analytic import AREA_LIGHT_VISIBLE

REPO = Path(__file__).resolve().parents[1]
CORNELL = REPO / "scenes" / "cornell.pbrt"
OVERRIDES = {"resolution": (32, 32), "spp": 2, "max_depth": 2}

RANK = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from curry_pbrt_tpu_torch.parallel.multihost import render_distributed
rank, init, out, scene = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
img = render_distributed(scene, overrides={overrides!r}, coordinator=init, num_processes=2,
                         process_id=rank, output=out + ".png", device="cpu")
np.save(f"{{out}}_{{rank}}.npy", img)
torch.distributed.destroy_process_group()  # a gloo group left to the exit can abort it
print("NO_JAX", "jax" not in sys.modules and "curry_pbrt_tpu" not in sys.modules)
print("RANK_OK", rank)
""".format(overrides=OVERRIDES)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: six xdist workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two rank processes' (stdout, image), and rank 0's PNG path."""
    tmp = tmp_path_factory.mktemp("multihost")
    init, stem = f"file://{tmp / 'store'}", str(tmp / "img")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    results = run_ranks(lambda r: [sys.executable, "-c", RANK, str(r), init, stem, str(CORNELL)],
                        2, timeout=240, env=env)
    for r, (rc, stdout, stderr) in enumerate(results):
        assert rc == 0 and f"RANK_OK {r}" in stdout, f"rank {r}:\n{stdout}\n{stderr[-3000:]}"
    return [(out, np.load(f"{stem}_{r}.npy")) for r, (_, out, _) in enumerate(results)], stem


def test_two_process_render_matches_single(two_ranks, tmp_path):
    (_, img0), (_, img1) = two_ranks[0]
    assert img0.shape == (32, 32, 3) and np.isfinite(img0).all() and img0.mean() > 0
    np.testing.assert_array_equal(img0, img1)  # both ranks hold the whole film
    assert Path(two_ranks[1] + ".png").stat().st_size > 0  # rank 0 wrote it
    single = render_distributed(CORNELL, overrides=OVERRIDES, output=str(tmp_path / "one.png"),
                                device="cpu")
    np.testing.assert_allclose(img0, single, atol=1e-6)


def test_rank_processes_import_no_jax(two_ranks):
    for out, _ in two_ranks[0]:
        assert "NO_JAX True" in out


def test_tent_filter_refused_at_more_than_one_process(tmp_path):
    """Raised before joining any group: the tent splat crosses pixel
    boundaries, so its sharded film would need a summed film."""
    scene = tmp_path / "tent.pbrt"
    scene.write_text(AREA_LIGHT_VISIBLE)
    with pytest.raises(ValueError, match="triangle"):
        render_distributed(scene, overrides={"filter": "triangle"},
                           coordinator=f"file://{tmp_path / 'store'}", num_processes=2,
                           process_id=0, device="cpu")
    # at one process the sharded path renders the box film, as the JAX
    # package's does whatever the filter
    tent, box = (render_distributed(scene, overrides={"filter": f, "spp": 2},
                                    output=str(tmp_path / f"{f}.png"), device="cpu")
                 for f in ("triangle", "box"))
    np.testing.assert_array_equal(tent, box)


def test_cli_device_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card path cannot be shown here")
    scene = tmp_path / "s.pbrt"
    scene.write_text(AREA_LIGHT_VISIBLE)
    with pytest.raises(RuntimeError, match="cuda"):
        main([str(scene), "--spp", "1", "-o", str(tmp_path / "x.png")])
    main([str(scene), "--spp", "1", "--device", "cpu", "-o", str(tmp_path / "x.png")])
    assert (tmp_path / "x.png").stat().st_size > 0


def test_run_ranks_stops_the_ranks_at_a_failure_and_at_the_time_limit():
    """A failing rank ends the run at once (the others are killed, as they
    would wait in a collective), and ranks still running at the limit are
    killed and the run raises."""
    sleep = [sys.executable, "-c", "import time; time.sleep(60)"]
    fail = [sys.executable, "-c", "import sys; print('failing'); sys.exit(3)"]
    res = run_ranks(lambda r: fail if r == 0 else sleep, 2, timeout=50)
    assert res[0][0] == 3 and "failing" in res[0][1]
    assert res[1][0] < 0  # killed
    with pytest.raises(TimeoutError, match="after 1"):
        run_ranks(lambda r: sleep, 2, timeout=1)
