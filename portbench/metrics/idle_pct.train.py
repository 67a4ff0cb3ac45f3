"""The share of the traced step's wall, one profiler session a step, in
which no operation ran on the card."""

UNIT = "%"
LAYER = "device"
MOVES = "step_s"


def read(rec):
    t = rec.get("trace")
    if not t or "steps" not in rec or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
