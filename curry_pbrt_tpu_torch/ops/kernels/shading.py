"""The host side of csrc/shading.cuh, the per-lane shading code that the NEE
kernels (nee.py) and the continuation kernel (shade.py) share: the ctypes
mirrors of its argument structs, the lobe-kind codes and the limits on a
plan's families, and the helpers that fill a struct from a tensor's pointer
and strides (an expanded constant keeps stride 0, so it is never copied)."""

from __future__ import annotations

import ctypes

import torch

from curry_pbrt_tpu_torch.dtypes import FLOAT_MAX, INV_PI, PI, Float, gamma

KINDS = {"lambert_r": 0, "ggx_r": 1, "spec_r": 2, "spec_t": 3}  # csrc/shading.cuh's codes
MAX_FAMS = 8  # family slots of a plan
MAX_LOBES = 4  # lobes of a family

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class Rows3(ctypes.Structure):
    _fields_ = [("p", _P), ("s0", _I), ("s1", _I)]


class Rows1(ctypes.Structure):
    _fields_ = [("p", _P), ("s0", _I), ("pad", _I)]


class Lobe(ctypes.Structure):
    _fields_ = [("kind", _I), ("fresnel_noop", _I), ("albedo", Rows3), ("alpha_x", Rows1),
                ("alpha_y", Rows1), ("eta_a", Rows1), ("eta_b", Rows1)]


class Consts(ctypes.Structure):
    _fields_ = [("pi", _F), ("inv_pi", _F), ("g6", _F), ("shadow_t", _F), ("fmax", _F),
                ("n_lights", _I)]


def rows3(t: torch.Tensor, n: int) -> Rows3:
    if t.shape != (n, 3) or t.dtype != torch.float32:
        raise ValueError(f"the shading kernels take (N, 3) float32 rows; got {tuple(t.shape)} "
                         f"{t.dtype} for N = {n}")
    return Rows3(t.data_ptr(), t.stride(0), t.stride(1))


def rows1(t: torch.Tensor, n: int) -> Rows1:
    if t.shape != (n,) or t.dtype != torch.float32:
        raise ValueError(f"the shading kernels take (N,) float32 values; got {tuple(t.shape)} "
                         f"{t.dtype} for N = {n}")
    return Rows1(t.data_ptr(), t.stride(0), 0)


def consts(n_lights: int) -> Consts:
    return Consts(float(PI), float(INV_PI), float(gamma(6)), float(Float(1.0 - 1e-5)),
                  float(FLOAT_MAX), n_lights)


def lobe(lb, n: int, reads) -> Lobe:
    """A lobe's struct: its kind, its albedo rows and the (N,) tensors
    named in `reads` (the others stay null)."""
    la = Lobe(KINDS[lb.kind], int(lb.fresnel_noop))
    la.albedo = rows3(lb.albedo, n)
    for name in reads:
        setattr(la, name, rows1(getattr(lb, name), n))
    return la
