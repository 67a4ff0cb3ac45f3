"""Host milliseconds of a pass's `prepare` span (render.render_plan: the
params tree to the device, every pixel's offset and xy, the programs'
params copy), while the card waits: the median over the process's passes
whose every chunk replayed. None where the program has no such span."""

import statistics

UNIT = "ms/pass"
LAYER = "chunk loop"
MOVES = "samples_per_s"


def read(rec):
    try:
        from curry_pbrt_tpu_torch.utils import trace
    except ImportError:
        return None
    ms = [1e3 * c.seconds for p in trace.trees("render_plan") if trace.fully_replayed(p)
          for c in p.children if c.name == "prepare"]
    return statistics.median(ms) if ms else None
