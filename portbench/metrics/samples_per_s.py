"""Camera samples (pixels × spp) of every pass completed in the window,
over the window's whole time from its start to the end of its last pass:
the cost of an image at a sample count. Host clock."""

UNIT = "samples/s"


def read(rec):
    return rec["samples"] / rec["window_s"] if "samples" in rec else None
