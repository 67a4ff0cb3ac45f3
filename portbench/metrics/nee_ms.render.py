"""Device milliseconds a pass of the `nee` stage: uniform_sample_one_light
(light sample, shadow ray, MIS leg) and its radiance update. From the
timing events that the program captures into its chunk programs
(curry_pbrt_tpu_torch/utils/trace.py), read in the traced pass, whose
every chunk replays, and summed over its chunks. None off the card, and
where the program has no such stages."""

UNIT = "ms/pass"
LAYER = "integrator: next-event estimation"
MOVES = "samples_per_s"


def read(rec):
    if rec.get("card", "cpu") == "cpu":
        return None
    try:
        from curry_pbrt_tpu_torch.utils import trace
    except ImportError:
        return None
    ms = trace.traced_pass_ms()
    return ms.get("nee") if ms else None
