"""torch.cuda.max_memory_allocated() over set-up and window, after
reset_peak_memory_stats() before set-up: what decides which scenes and
resolutions fit on a card."""

UNIT = "GiB"


def read(rec):
    return rec["peak_bytes"] / 2**30 if rec["peak_bytes"] else None
