"""The arithmetic of the result line: rates over the whole window, the
idle share from kernel intervals, the bytes bound, and the names the
trace is read by."""

import pytest

from portbench import roofline
from portbench.bench import ROOT, load_module
from portbench.trace import base_name, csrc_kernels, union_us


def read(metric, rec):
    return load_module("metrics", metric).read(rec)


def test_rates_are_over_the_whole_window():
    # 7 passes of 16.78M samples in a window of 9.1 s (the last pass ended it)
    rec = {"samples": 7 * 16_777_216, "window_s": 9.1}
    assert read("samples_per_s", rec) == pytest.approx(7 * 16_777_216 / 9.1)
    assert read("step_s", rec) is None
    rec = {"steps": 5, "window_s": 41.5}
    assert read("step_s", rec) == pytest.approx(8.3)
    assert read("samples_per_s", rec) is None
    assert read("peak_gib", {"peak_bytes": 3 * 2**30}) == 3.0
    assert read("peak_gib", {"peak_bytes": 0}) is None  # no card, no reading


def test_union_of_intervals():
    assert union_us([]) == 0.0
    assert union_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17.0
    assert union_us([(3, 4), (0, 1)]) == 2.0


def test_idle_share_from_the_sessions():
    trace = {"busy_s": 0.9, "window_s": 1.2, "records": [], "passes": 1}
    assert read("idle_pct.render", {"samples": 1, "trace": trace}) == pytest.approx(25.0)
    assert read("idle_pct.train", {"samples": 1, "trace": trace}) is None
    assert read("idle_pct.train", {"steps": 1, "trace": trace}) == pytest.approx(25.0)
    assert read("idle_pct.render", {"samples": 1}) is None  # untraced: nothing to read


def test_bytes_bound_and_the_roofline_share():
    # 1M rays, a quarter live: 250k·28 + 750k·4 in, 8 B out each, 1 KB of tables
    n = call = roofline.call_bytes(1_000_000, 250_000, 8_000_000, 1_024)
    assert n == 250_000 * 28 + 750_000 * 4 + 8_000_000 + 1_024
    calls = [{"rays": 1_000_000, "live": 250_000, "out_bytes": 8_000_000, "table_bytes": 1_024}]
    card = "NVIDIA H100 80GB HBM3"
    assert roofline.bound_s(calls, card) == pytest.approx(call / 3.35e12)
    assert roofline.bound_s(calls, "some other card") is None
    csrc = frozenset({"small_kernel"})
    trace = {"calls": calls * 2, "csrc": csrc, "passes": 1,
             "records": [("void curry::(anonymous namespace)::small_kernel<false, false>(float "
                          "const*)", 40.0), ("void at::native::vectorized_elementwise_kernel<4>("
                                             "int)", 500.0)]}
    share = read("traversal_roofline_pct.render", {"card": card, "trace": trace})
    assert share == pytest.approx(100 * 2 * call / 3.35e12 / 40e-6)
    assert read("torch_ms.render", {"trace": trace}) == pytest.approx(0.5)
    assert read("traversal_roofline_pct.render", {"card": "cpu", "trace": trace}) is None


def test_kernel_names():
    assert base_name("void curry::(anonymous namespace)::closest_warp_kernel<curry::TriPrim, "
                     "false>(float const*, int)") == "closest_warp_kernel"
    assert base_name("void at::native::vectorized_elementwise_kernel<4, at::native::"
                     "CUDAFunctor_add<float> >(int)") == "vectorized_elementwise_kernel"
    assert base_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"
    names = csrc_kernels(ROOT / "curry_pbrt_tpu_torch")
    assert {"small_kernel", "closest_warp_kernel", "any_warp_kernel", "walk_kernel"} <= names
    assert "vectorized_elementwise_kernel" not in names
