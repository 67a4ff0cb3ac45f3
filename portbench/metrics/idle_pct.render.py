"""The share of the traced pass's wall, one profiler session a chunk
program's run, in which no operation ran on the card."""

UNIT = "%"
LAYER = "device"
MOVES = "samples_per_s"


def read(rec):
    t = rec.get("trace")
    if not t or "samples" not in rec or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
