"""Process start (the harness's first line) to window start: imports, the
card's start, the kernels' build or load, scene compile and plan, and the
warm-up that records the chunk programs or drives the first steps. Host
clock."""

UNIT = "s"


def read(rec):
    return rec["setup_s"]
