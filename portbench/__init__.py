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
"""
