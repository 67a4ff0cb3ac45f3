"""The port's examples (curry_pbrt_tpu_torch/examples/) against their JAX
twins in examples/, run on the CPU.

  - parse and parse_lex print exactly what the JAX examples print for
    scenes/cornell.pbrt;
  - halton_sampler prints the same 256 values (bit-equal samples);
  - concentric_sample_disk within 2 ULP of float32 (sin / cos of the two
    libraries may differ in the last bits);
  - raymond_post_effect: the same pixels as the JAX example's PNG, and the
    bytes of the port's PNG writer on those pixels. The two packages' PNG
    files cannot be byte-equal: the JAX package writes through PIL, which
    picks a row filter adaptively, and the port's stdlib writer uses
    filter 0 on every row;
  - render_from_file, run as `python -m` with --device cpu at 16², 2 spp,
    writes the PNG byte for byte that the port's cli writes for the same
    arguments.
"""

import io
import os
import runpy
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from curry_pbrt_tpu_torch.utils.imageio import read_png, write_png

REPO = Path(__file__).resolve().parents[1]
CORNELL = str(REPO / "scenes" / "cornell.pbrt")


def run_jax_example(name, *args):
    """The JAX example script in this process (jax is already loaded),
    as `python examples/<name>.py args` → its standard output."""
    argv = sys.argv
    sys.argv = [name, *args]
    out = io.StringIO()
    try:
        with redirect_stdout(out):
            runpy.run_path(str(REPO / "examples" / f"{name}.py"), run_name="__main__")
    finally:
        sys.argv = argv
    return out.getvalue()


def run_port_example(name, *args):
    import importlib

    mod = importlib.import_module(f"curry_pbrt_tpu_torch.examples.{name}")
    out = io.StringIO()
    with redirect_stdout(out):
        mod.main(list(args))
    return out.getvalue()


@pytest.mark.parametrize("name", ["parse", "parse_lex", "halton_sampler"])
def test_printed_output_equals_jax(name):
    args = (CORNELL,) if name.startswith("parse") else ()
    port = run_port_example(name, *args)
    assert port.count("\n") > 20
    assert port == run_jax_example(name, *args)


def test_concentric_sample_disk_within_2_ulp():
    port = np.array(run_port_example("concentric_sample_disk").split(), np.float32)
    ref = np.array(run_jax_example("concentric_sample_disk").split(), np.float32)
    assert port.shape == ref.shape == (256,)
    ulp = np.spacing(np.maximum(np.abs(port), np.abs(ref)))
    assert np.all(np.abs(port - ref) <= 2 * ulp), np.max(np.abs(port - ref) / ulp)


def test_raymond_post_effect_matches_jax(tmp_path):
    src = str(REPO / "scenes" / "box-texture.png")
    run_jax_example("raymond_post_effect", src, str(tmp_path / "jax.png"))
    run_port_example("raymond_post_effect", src, str(tmp_path / "port.png"))
    from PIL import Image

    ref = np.asarray(Image.open(tmp_path / "jax.png").convert("RGB"))
    got = read_png(tmp_path / "port.png")
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(ref, np.asarray(Image.open(src).convert("RGB")))  # it swirled
    write_png(tmp_path / "again.png", ref)
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "again.png").read_bytes()


def test_render_from_file_writes_the_cli_png(tmp_path):
    args = ["--device", "cpu", "--res", "16", "16", "--spp", "2", "--quiet"]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "curry_pbrt_tpu_torch.examples.render_from_file", CORNELL,
         "-o", str(tmp_path / "example.png"), *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("example.png")
    from curry_pbrt_tpu_torch.cli import main

    with redirect_stdout(io.StringIO()):
        main([CORNELL, "-o", str(tmp_path / "cli.png"), *args])
    png = (tmp_path / "example.png").read_bytes()
    assert png == (tmp_path / "cli.png").read_bytes()
    assert read_png(tmp_path / "example.png").shape == (16, 16, 3)
