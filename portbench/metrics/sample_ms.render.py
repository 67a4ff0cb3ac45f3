"""Device milliseconds a pass of the `sample` stage: the Halton work
(halton_indices, the camera's dims, each bounce's _bounce_u). From the
timing events that the program captures into its chunk programs
(curry_pbrt_tpu_torch/utils/trace.py), read in the traced pass, whose
every chunk replays, and summed over its chunks. None off the card, and
where the program has no such stages."""

UNIT = "ms/pass"
LAYER = "sampler"
MOVES = "samples_per_s"


def read(rec):
    if rec.get("card", "cpu") == "cpu":
        return None
    try:
        from curry_pbrt_tpu_torch.utils import trace
    except ImportError:
        return None
    ms = trace.traced_pass_ms()
    return ms.get("sample") if ms else None
