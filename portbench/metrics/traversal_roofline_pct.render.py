"""The traversal kernels' share of their bytes roofline in a pass: the
least time the card needs to move the bytes of every table-walk launch of
the pass (portbench/roofline.py: rays, live rays and tables of each call,
noted in an eager pass that makes the replay's calls) over the device time
of the port's csrc kernels in the traced, replayed pass. Bytes only: the
operations side waits for per-call tile counts from inside the program."""

from portbench.roofline import bound_s
from portbench.trace import base_name

UNIT = "%"
LAYER = "traversal kernels"
MOVES = "samples_per_s"


def read(rec):
    t = rec.get("trace")
    if not t or not t.get("calls"):
        return None
    us = sum(d for name, d in t["records"] if base_name(name) in t["csrc"])
    bound = bound_s(t["calls"], rec["card"])
    if us <= 0 or bound is None:
        return None
    return 100.0 * bound / (us / 1e6 / t["passes"])
