"""Precision policy and numeric constants.

Mirrors the JAX package's dtypes (curry_pbrt_tpu/dtypes.py): Float=f32,
Integer=i32, MACHINE_EPSILON = f32 eps / 2. All device compute is f32;
counters and ids are integer tensors.
"""

import numpy as np

Float = np.float32
Integer = np.int32

# f32 machine epsilon / 2 — pbrt's rounding-error bound unit.
MACHINE_EPSILON = Float(np.finfo(np.float32).eps / 2)

PI = Float(np.pi)
INV_PI = Float(1.0 / np.pi)
INF = Float(np.inf)
# Largest finite f32 — the reference's Float::max_value() for an unbounded
# ray t_max (reference src/geometry/ray.rs:23).
FLOAT_MAX = Float(np.finfo(np.float32).max)

# t_max for from→to shadow rays: 1 - 1e-5 (reference src/geometry/ray.rs:30-36)
SHADOW_EPS = Float(1e-5)


def gamma(n: int) -> Float:
    """Conservative fp error bound γ(n) = nε/(1−nε)."""
    ne = Float(n) * MACHINE_EPSILON
    return Float(ne / (Float(1.0) - ne))
