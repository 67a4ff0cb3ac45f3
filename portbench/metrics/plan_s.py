"""Host seconds of the port's scene compile (sceneio.compile_scene_file)
and plan (render.plan_render) in set-up."""

UNIT = "s"
LAYER = "scene compile + plan"
MOVES = "setup_s"


def read(rec):
    return rec.get("plan_s")
