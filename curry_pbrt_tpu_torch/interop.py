"""Carry parameters and compiled scene arrays over from the JAX package.

Everything crosses as numpy arrays, so this module imports no JAX: export a
JAX pytree or a JAX-compiled scene's arrays with `np.asarray` on the JAX
side, then load them here.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from curry_pbrt_tpu_torch.models.lights import LightArrays
from curry_pbrt_tpu_torch.ops.intersect import SphereArrays, TriangleArrays


def params_from_numpy(tree, device):
    """A scene params tree — the JAX `Scene.init_params` layout: {"materials":
    {id: {slot: value}}, "textures": {key: (H,W,3)}, "light_L": (L,3)} — with
    numpy (or tensor) leaves → the same tree of tensors on `device`.

    The leaves that need a copy travel together, one transfer per dtype, and
    become views of it: a scene with 10,000 materials has 20,000 leaves, and
    one copy each would be 20,000 transfers per render call. Tensors already
    on `device`, and tensors that require grad (so that autograd still
    reaches them), are moved one by one."""
    device = torch.device(device)
    if not isinstance(tree, dict):
        return params_from_numpy({"leaf": tree}, device)["leaf"]
    pending = []  # (parent, key, CPU tensor)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif isinstance(v, torch.Tensor) and (v.requires_grad or v.device == device):
                out[k] = v.to(device)
            else:  # a copy: JAX exports are read-only
                cpu = v.cpu() if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))
                pending.append((out, k, cpu))
        return out

    out = walk(tree)
    by_dtype = {}
    for item in pending:
        by_dtype.setdefault(item[2].dtype, []).append(item)
    for items in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for _, _, t in items]).to(device)
        pieces = torch.split(flat, [t.numel() for _, _, t in items])
        for (parent, k, t), piece in zip(items, pieces):
            parent[k] = piece.view(t.shape)
    return out


def scene_arrays_from_numpy(scene, tris, spheres, lights):
    """Port `scene` with its geometry and light tables replaced by a JAX
    compile's arrays (sequences of numpy arrays in the JAX field order:
    TriangleArrays(p0, p1, p2, prim), SphereArrays(o2w, w2o, radius, prim),
    LightArrays(type_id, ..., env_id))."""
    return replace(
        scene,
        tris=TriangleArrays(*(np.asarray(a) for a in tris)),
        spheres=SphereArrays(*(np.asarray(a) for a in spheres)),
        lights=LightArrays(*(np.asarray(a) for a in lights)),
    )
