"""Host seconds of every chunk program's recording (the `record` spans of
render.ChunkPrograms) in the process: set-up that the warm-up pays. None
where the program has no such span or recorded nothing."""

UNIT = "s"
LAYER = "chunk program"
MOVES = "setup_s"


def read(rec):
    try:
        from curry_pbrt_tpu_torch.utils import trace
    except ImportError:
        return None
    n, seconds = trace.totals().get("record", (0, 0.0))
    return seconds if n else None
