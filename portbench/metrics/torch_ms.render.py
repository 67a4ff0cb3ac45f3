"""Device milliseconds a pass of every operation that is not one of the
port's csrc kernels (the integrator's, sampler's, shading's and film's
PyTorch ops, copies included), from the traced pass's profiler records:
where the elementwise levers show."""

from portbench.trace import base_name

UNIT = "ms/pass"
LAYER = "integrator, sampler, shading and film"
MOVES = "samples_per_s"


def read(rec):
    t = rec.get("trace")
    if not t or "passes" not in t:
        return None
    us = sum(d for name, d in t["records"] if base_name(name) not in t["csrc"])
    return us / 1e3 / t["passes"] if us > 0 else None
