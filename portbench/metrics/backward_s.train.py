"""The traced step's own backward seconds (parallel/mesh.py
backward_over_pixels' times["backward_s"], synchronised around each
sub-chunk's backward), a step."""

UNIT = "s/step"
LAYER = "train step"
MOVES = "step_s"


def read(rec):
    t = rec.get("trace")
    if not t or "times" not in t or "backward_s" not in t["times"]:
        return None
    return t["times"]["backward_s"] / t["steps"]
