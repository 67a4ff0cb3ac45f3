"""The PyTorch port stands alone: it imports no JAX, it has no silent
fallback from the card to the CPU, and its chip smoke run refuses to run
without a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


def _run(code: str, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    """Every module of the package (pkgutil.walk_packages), imported in a
    fresh interpreter, brings in neither jax nor the JAX package."""
    res = _run(
        "import importlib, pkgutil, sys\n"
        "import curry_pbrt_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "assert 'curry_pbrt_tpu_torch.ops.kernels.sphere_kernel' in names, names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert not any(m.startswith('curry_pbrt_tpu.') or m == 'curry_pbrt_tpu'\n"
        "               for m in sys.modules)\n"
        "print('ok')\n"
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_cuda_device_without_a_card_raises():
    """device='cuda' never falls back to the CPU."""
    from curry_pbrt_tpu_torch.render import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card path cannot be shown here")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_fails_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without CUDA,
    and alone in a directory without the package."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", lone)
    res = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
