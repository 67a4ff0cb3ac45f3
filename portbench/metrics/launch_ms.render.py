"""Device milliseconds a pass of the `launch` stage: a replay's
static-input copies and graph launch, from an event recorded before the
copies to the program's first captured boundary. From the timing events that
the program captures into its chunk programs
(curry_pbrt_tpu_torch/utils/trace.py), read in the traced pass, whose
every chunk replays, and summed over its chunks. None off the card, and
where the program has no such stages."""

UNIT = "ms/pass"
LAYER = "chunk program"
MOVES = "samples_per_s"


def read(rec):
    if rec.get("card", "cpu") == "cpu":
        return None
    try:
        from curry_pbrt_tpu_torch.utils import trace
    except ImportError:
        return None
    ms = trace.traced_pass_ms()
    return ms.get("launch") if ms else None
