"""The benchmark of the PyTorch + CUDA port (curry_pbrt_tpu_torch).

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

BENCHMARK.json, at the root of the checkout, names the cells. A cell is a
configuration (configs/<name>.json: scene, size, sampler, integrator)
under a traffic mix (traffic/<name>.json: what a window repeats), and its
check (checks/<cell>.json: the numbers compared and their limits). A
traffic mix names its kind (kinds/<kind>.py: set-up, one unit of work,
the trace hooks, the check), and every metric has a reader of its own
(metrics/<metric>.py). All are found by name: a cell, a mix or a metric
is added by adding files. The plain reference (ref/) decides `correct`.

A cell on one card runs in the process that `run` starts. A cell whose
`chips` is more runs one rank process a card (ranks.py): each rank pins
its card, joins the default NCCL group that the program's
`parallel.mesh.make_mesh()` finds, and runs set-up, window, trace and
check; rank 0's clock ends the window for every rank, so all run the same
units. Only a kind that sets `RANKS = True` runs so (others are refused);
its `setup` reads `rec["rank"]` and `rec["world"]`, its `work` is taken
from rank 0 (it counts the whole job once), and its `trace` leaves
`rec["trace"]` with `records`, `busy_s` and `window_s`. Each compared
number is the worst over the ranks, and `correct` needs every rank's
check to pass. `device.count` is, at any number of cards, the number of
distinct card UUIDs on which the run allocated memory; a run that used
other cards than the cell asks for exits 1 with no result.
"""
