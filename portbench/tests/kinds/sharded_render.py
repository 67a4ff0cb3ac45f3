"""A kind for the card tests, copied into a copy's kinds/: whole passes of
the port's sharded render, parallel.mesh.render_chunk_sharded, one pixel
slab a rank, the film rows gathered over the default group (NCCL at
several cards) onto every rank. The check: each rank's gathered image
against render.render_plan's on the rank's own card, bit for bit (each ray
depends only on its pixel and sample)."""

import numpy as np

from portbench.trace import Sessions

RANKS = True


def setup(cell, seed, dev, rec):
    from curry_pbrt_tpu_torch.parallel.mesh import make_mesh
    from curry_pbrt_tpu_torch.render import pixel_arrays, plan_render
    from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file

    scene = compile_scene_file(cell.scene_path, cell.overrides(seed))
    mesh = make_mesh(rec["world"], device=dev)
    plan = plan_render(scene, device=mesh.device, intersector=cell.config["intersector"])
    state = {"plan": plan, "mesh": mesh, "params": scene.init_params,
             "pixels": pixel_arrays(plan)}
    unit(state)  # the warm-up
    return state


def unit(state) -> bool:
    from curry_pbrt_tpu_torch.parallel.mesh import render_chunk_sharded

    film = render_chunk_sharded(state["plan"], state["mesh"], state["params"], *state["pixels"])
    state["last"] = film.cpu().numpy()  # reads the film back: the pass has ended
    return True


def work(state, units: int) -> dict:
    xres, yres = state["plan"].scene.settings.resolution
    return {"samples": units * xres * yres * state["plan"].scene.settings.spp}


def trace(state, rec):
    sessions = Sessions(state["plan"].device)
    with sessions.unit():
        unit(state)
    summary, ops = sessions.summary()
    rec["trace"] = dict(summary, passes=1)
    return {"device_ops": ops, "idle_gaps": []}


def check(state, cell, seed) -> dict:
    from curry_pbrt_tpu_torch.render import render_plan

    one = render_plan(state["plan"], show_progress=False).reshape(-1, 3)
    img = state["last"].reshape(-1, 3)
    differing = np.any(img.view(np.uint32) != one.view(np.uint32), axis=-1)
    return {"px_differing_from_one_card": (float(differing.sum()), 0.0)}
