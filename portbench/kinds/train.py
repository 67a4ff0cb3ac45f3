"""Traffic kind "train": whole inverse-rendering steps of the port's train
step, `parallel.mesh.make_train_step(plan, optimizer)`, over every pixel,
back to back on one step object.

Set-up compiles and plans the scene (plan_s), renders the target at the
scene's own params (`render.render_plan`, eagerly: its plan renders one
pass), sets every leaf under the traffic's params subtree to its `init`,
builds the optimizer and the step, and drives the step through its first
`checked_steps` steps, which the check follows; the window's steps go on
from there with the same object. A step renders every pixel's samples
with autograd, a render chunk at a time, back-propagates each chunk's
share of the MSE, and steps the optimizer; it ends in a synchronise.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from portbench.trace import Sessions


def make_optimizer(leaves, opt: dict):
    """A torch.optim optimizer from the traffic's {"name", "lr", ...}."""
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in opt.items() if k != "name"}
    return getattr(torch.optim, opt["name"])(leaves, **kw)


def first_grads(optimizer, leaves):
    """The gradient the optimizer took at its first step, worked out from
    its state: Adam's first moment after one step is (1 - beta1) · g. An
    optimizer that has no state has taken none (zeros)."""
    if not isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        raise ValueError(f"no rule for the first gradient of {type(optimizer).__name__}")
    beta1 = optimizer.param_groups[0]["betas"][0]
    return [optimizer.state[x]["exp_avg"] / (1.0 - beta1) if "exp_avg" in optimizer.state[x]
            else torch.zeros_like(x) for x in leaves]


def setup(cell, seed, dev, rec):
    from curry_pbrt_tpu_torch.interop import params_from_numpy
    from curry_pbrt_tpu_torch.parallel.mesh import make_train_step
    from curry_pbrt_tpu_torch.render import pixel_arrays, plan_render, render_plan
    from curry_pbrt_tpu_torch.sceneio.compiler import compile_scene_file

    traffic = cell.traffic
    t0 = time.perf_counter()
    scene = compile_scene_file(cell.scene_path, cell.overrides(seed))
    plan = plan_render(scene, device=dev, intersector=cell.config["intersector"])
    rec["plan_s"] = time.perf_counter() - t0
    target = render_plan(plan, show_progress=False, graph=False)
    target = torch.as_tensor(target.reshape(-1, 3)).to(dev)
    params = params_from_numpy(scene.init_params, dev)
    node = params[traffic["leaves"]]
    leaves = []
    for k in sorted(node):
        node[k] = torch.full_like(node[k], float(traffic["init"])).requires_grad_(True)
        leaves.append(node[k])
    start = [x.detach().clone() for x in leaves]
    optimizer = make_optimizer(leaves, traffic["optimizer"])
    po, px = pixel_arrays(plan)
    state = {"plan": plan, "step": make_train_step(plan, optimizer), "params": params,
             "target": target, "po": po, "px": px, "losses": []}
    grads = None
    for _ in range(traffic["checked_steps"]):
        unit(state)
        if grads is None:
            grads = [g.clone() for g in first_grads(optimizer, leaves)]
    state["checked"] = {"losses": list(state["losses"]), "grads": grads, "start": start,
                        "end": [x.detach().clone() for x in leaves]}
    state["losses"].clear()
    return state


def unit(state, times=None) -> bool:
    """One step; False where its loss is not finite."""
    loss = state["step"](state["params"], state["target"], state["po"], state["px"], times=times)
    loss = float(loss)  # reads the loss back: the step has ended
    state["losses"].append(loss)
    return math.isfinite(loss)


def answers(state) -> dict:
    """The program's answers: the checked steps' losses, first gradients
    and leaves before and after."""
    return state["checked"]


def work(state, units: int) -> dict:
    return {"steps": units}


def trace(state, rec):
    """One more step in a profiler session of its own, with the step's
    forward and backward seconds (synchronised around each sub-chunk)."""
    sessions = Sessions(state["plan"].device)
    times = {}
    with sessions.unit():
        unit(state, times)
    summary, ops = sessions.summary()
    rec["trace"] = dict(summary, steps=1, times=times)
    return {"device_ops": ops, "idle_gaps": []}


def _leaf_gap(prog, ref) -> float:
    """The worst leaf's gap between the two sides' norms, over the larger of
    that leaf's reference norm and the median leaf's."""
    pn = [float(torch.linalg.vector_norm(x.double())) for x in prog]
    rn = [float(torch.linalg.vector_norm(x.double())) for x in ref]
    median = float(np.median(rn))
    return max(abs(p - r) / max(r, median) for p, r in zip(pn, rn))


def compare(prog: dict, ref: dict, check: dict) -> dict:
    """{name: (value, limit)}: loss_gap, the worst step's relative loss gap;
    grad_gap, the first gradient's norms (_leaf_gap); change_gap, the
    norms of each leaf's change over the checked steps."""
    limits = check["limits"]
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    change = _leaf_gap([e.cpu() - s.cpu() for s, e in zip(prog["start"], prog["end"])],
                       [e.cpu() - s.cpu() for s, e in zip(ref["start"], ref["end"])])
    return {
        "loss_gap": (loss, limits["loss_gap"]),
        "grad_gap": (_leaf_gap([g.cpu() for g in prog["grads"]], [g.cpu() for g in ref["grads"]]),
                     limits["grad_gap"]),
        "change_gap": (change, limits["change_gap"]),
    }


def reference(cell, seed, device, store=None, pixels=None) -> dict:
    from portbench.ref.render import Reference

    t = cell.traffic
    ref = Reference(cell.scene_path, cell.overrides(seed), device)
    return ref.train(t["leaves"], t["init"], t["optimizer"], t["checked_steps"], store=store,
                     pixels=pixels)


def control(cell, seed, device, store) -> dict:
    """The reference with its ray state passed through `store`, in the
    program's place."""
    return reference(cell, seed, device, store)


def faults(cell, seed, device) -> dict:
    """The reference in the program's place with half of the batch (the
    first half of the pixels, in raster order) left out and the mean taken
    over the rest. (A state left unchanged reads 1 and needs no run.)"""
    n = cell.config["resolution"][0] * cell.config["resolution"][1]
    return {"half_batch": reference(cell, seed, device, pixels=torch.arange(n // 2, n,
                                                                           device=device))}


def check(state, cell, seed) -> dict:
    prog = answers(state)
    device = state["plan"].device
    state.clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return compare(prog, reference(cell, seed, device), cell.check)
