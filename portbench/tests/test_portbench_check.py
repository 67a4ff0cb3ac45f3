"""The check decides `correct`: a sound run of each cell passes it, its
lower-precision control fails it, and so does a run of each cell with the
timed path broken underneath, once for each fault the cell can have (an
answer altered where it is produced; half of the batch left out and the
mean taken over the rest; a step that returns its state unchanged). The
runs skip the look for a card and run the cells cut to a CPU's size, with
the limits of the check files."""

import pytest
import torch

from portbench.bench import load_module, measure
from portbench.ref.render import bf16_store
from portbench.tests.helpers import SEED, tiny_cell

RENDERS = ["cornell_tex_512.render", "mesh10k_1024.render"]
TRAIN = "cornell_tex_512.train"


def run(workload):
    result, numbers = measure(tiny_cell(workload), SEED, 0.0, False, "cpu")
    return result, numbers


@pytest.mark.parametrize("workload", RENDERS + [TRAIN])
def test_a_sound_run_is_correct(workload):
    result, numbers = run(workload)
    assert result["correct"], numbers
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "compared"
    assert set(result["compared"]) == set(numbers)


@pytest.mark.parametrize("workload", RENDERS + [TRAIN])
def test_the_bf16_control_is_not_correct(workload):
    cell = tiny_cell(workload)
    kind = load_module("kinds", cell.traffic["kind"])
    numbers = kind.compare(kind.control(cell, SEED, "cpu", bf16_store),
                           kind.reference(cell, SEED, "cpu"), cell.check)
    assert any(v > limit for v, limit in numbers.values()), numbers


def _scaled_chunk(real):
    def chunk(*a, **kw):  # an answer altered where it is produced
        means, bad, segments = real(*a, **kw)
        return means * 1.001, bad, segments
    return chunk


def _half_samples(real):
    def accumulate_box(radiance, spp, return_nan_counts=False):
        # half of each pixel's samples left out, the mean over the rest
        r = radiance.reshape(-1, spp, 3)[:, : spp // 2].reshape(-1, 3)
        return real(r, spp // 2, return_nan_counts)
    return accumulate_box


@pytest.mark.parametrize("workload", RENDERS)
@pytest.mark.parametrize("fault", ["answer_altered", "half_the_samples"])
def test_a_broken_render_is_not_correct(workload, fault, monkeypatch):
    from curry_pbrt_tpu_torch import render
    from curry_pbrt_tpu_torch.ops import film

    if fault == "answer_altered":
        monkeypatch.setattr(render, "_render_chunk", _scaled_chunk(render._render_chunk))
    else:
        monkeypatch.setattr(film, "accumulate_box", _half_samples(film.accumulate_box))
    result, numbers = run(workload)
    assert not result["correct"], numbers


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "answer_altered"])
def test_a_broken_train_step_is_not_correct(fault, monkeypatch):
    from curry_pbrt_tpu_torch.parallel import mesh

    real = mesh.backward_over_pixels
    if fault == "state_unchanged":
        make = mesh.make_train_step

        def frozen(plan, optimizer):
            optimizer.step = lambda closure=None: None
            return make(plan, optimizer)

        monkeypatch.setattr(mesh, "make_train_step", frozen)
    elif fault == "half_the_batch":
        def half(plan, params, po, px, pixel_loss, times=None):
            h = po.shape[0] // 2
            return real(plan, params, po[h:], px[h:], lambda img, sl: pixel_loss(img, sl), times)

        def mse_half(target):
            h = target.shape[0] // 2
            return lambda img, sl: torch.sum((img - target[h:][sl]) ** 2) / target[h:].numel()

        monkeypatch.setattr(mesh, "backward_over_pixels", half)
        monkeypatch.setattr(mesh, "mse_pixel_loss", mse_half)
    else:
        monkeypatch.setattr(mesh, "backward_over_pixels", lambda *a, **kw: real(*a, **kw) * 1.001)
    result, numbers = run(TRAIN)
    assert not result["correct"], numbers
