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
    numpy (or tensor) leaves → the same tree of tensors on `device`."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return torch.tensor(np.asarray(tree), device=device)  # a copy: JAX exports are read-only


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
