"""The window's whole time over the optimizer steps completed in it: the
cost of an inverse-rendering iteration. Host clock."""

UNIT = "s"


def read(rec):
    return rec["window_s"] / rec["steps"] if "steps" in rec else None
