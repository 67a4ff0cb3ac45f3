"""Stateless vectorized Halton sampler (counterpart of the JAX package's
ops/halton.py — same indices, same digits, same affine scrambling).

    index(pixel, k) = pixel_offset[pixel] + k * (scale_x * scale_y)
    dim 0: radical_inverse(index / scale_x, base 2)   (pixel-stratifying)
    dim 1: radical_inverse(index / scale_y, base 3)
    dim d >= 2: scrambled_radical_inverse(index, prime[d]) with seeded
    affine digit permutations π(d) = (a·d + b) mod p.

Indices are uint32 in the reference; torch has no full uint32 arithmetic,
so every index and digit here is an int64 tensor holding the uint32 value,
and the hash masks each wrapping multiply with `& 0xFFFFFFFF`. Division
and modulo of non-negative int64 values equal the unsigned uint32 results.

`pixel_offset` and the permutation table are host-side numpy (pure
functions of the pixel grid and the seed).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.ref.dtypes import Float


def _first_primes(n: int) -> list:
    """Sieve the first n primes (reference table: halton.rs:141-203)."""
    # n-th prime < n (ln n + ln ln n) for n >= 6; 1000th prime = 7919
    limit = max(int(n * (np.log(n) + np.log(np.log(n)))) + 10, 30)
    sieve = np.ones(limit, bool)
    sieve[:2] = False
    for p in range(2, int(limit**0.5) + 1):
        if sieve[p]:
            sieve[p * p :: p] = False
    primes = np.nonzero(sieve)[0][:n]
    assert len(primes) == n
    return [int(p) for p in primes]


PRIMES = _first_primes(1000)
MAX_DIMS = len(PRIMES)

ONE_MINUS_EPS = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
_U32 = 0xFFFFFFFF


def _max_digits(base: int) -> int:
    """Digits needed to exhaust a uint32 in `base`."""
    n, d = 1, 0
    while n < 2**32:
        n *= base
        d += 1
    return d


def make_permutations(seed: int) -> np.ndarray:
    """Seeded affine digit-permutation coefficients per prime: (MAX_DIMS, 2)
    int32, row i = (a_i, b_i), π_i(d) = (a_i·d + b_i) mod PRIMES[i]."""
    rng = np.random.RandomState(seed)
    out = np.empty((MAX_DIMS, 2), dtype=np.int32)
    for i, p in enumerate(PRIMES):
        out[i, 0] = 1 if p == 2 else rng.randint(1, p)
        out[i, 1] = rng.randint(0, p)
    return out


class HaltonConfig(NamedTuple):
    """Static per-render sampler config (all Python ints)."""

    scale_x: int
    scale_y: int
    exp_x: int
    exp_y: int
    spp: int
    seed: int

    @property
    def scale_prod(self) -> int:
        return self.scale_x * self.scale_y

    @property
    def max_index(self) -> int:
        """Exclusive upper bound on any Halton index this render produces;
        digit loops stop once it is covered (bit-exact: every higher digit
        is zero)."""
        return self.scale_prod * max(self.spp, 1)


def make_halton_config(resolution, spp: int, seed: int = 0) -> HaltonConfig:
    xres, yres = int(resolution[0]), int(resolution[1])
    scale, exp = [1, 1], [0, 0]
    for i, base in enumerate((2, 3)):
        while scale[i] < (xres, yres)[i]:
            scale[i] *= base
            exp[i] += 1
    return HaltonConfig(scale[0], scale[1], exp[0], exp[1], spp, seed)


def compute_pixel_offsets(cfg: HaltonConfig) -> np.ndarray:
    """(scale_y, scale_x) uint32: entry [y, x] is the smallest Halton index
    whose first two scaled radical inverses land in pixel (x, y)
    (halton.rs:108-119). Callers slice to the film."""

    def inverse_exp(vals: np.ndarray, base: int, exp: int) -> np.ndarray:
        x = vals.astype(np.int64)
        acc = np.zeros_like(x)
        digit_count = np.zeros_like(x)
        for _ in range(max(exp, 1)):
            nz = x != 0
            digit = x % base
            x = x // base
            acc = np.where(nz, acc * base + digit, acc)
            digit_count = np.where(nz, digit_count + 1, digit_count)
        pad = np.maximum(exp - digit_count, 0)
        return acc * np.power(base, pad)

    xs = inverse_exp(np.arange(0, cfg.scale_x, dtype=np.int64), 2, cfg.exp_x)
    ys = inverse_exp(np.arange(0, cfg.scale_y, dtype=np.int64), 3, cfg.exp_y)
    minv_x = pow(cfg.scale_y, -1, cfg.scale_x) if cfg.scale_x > 1 else 0
    minv_y = pow(cfg.scale_x, -1, cfg.scale_y) if cfg.scale_y > 1 else 0
    offs = (
        xs[None, :] * cfg.scale_y * minv_x + ys[:, None] * cfg.scale_x * minv_y
    ) % cfg.scale_prod
    return offs.astype(np.uint32)


def halton_indices(pixel_offsets, sample_idx, cfg: HaltonConfig):
    """pixel_offsets, sample_idx: (...,) int64 → (...,) int64 uint32 values."""
    return (pixel_offsets + sample_idx * cfg.scale_prod) & _U32


def _digits_for(base: int, max_index) -> int:
    """Digit-loop trip count covering every index < max_index (None → the
    full uint32 range)."""
    full = _max_digits(base)
    if not max_index or max_index <= 0:
        return full
    k, cap = 0, 1
    while cap < max_index and k < full:
        cap *= base
        k += 1
    return k if cap >= max_index else full


def radical_inverse(x, base: int, max_index=None):
    """Plain radical inverse of the uint32 values in int64 tensor x,
    accumulated per digit in f32 (LSB digit first) exactly like the JAX
    package."""
    r = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    w = Float(1.0 / base)
    for _ in range(_digits_for(base, max_index)):
        nz = x != 0
        digit = x % base
        x = x // base
        r = torch.where(nz, r + digit.to(torch.float32) * float(w), r)
        w = w * Float(1.0 / base)
    return r


def scrambled_radical_inverse(x, dim: int, perms, max_index=None):
    """Scrambled radical inverse with the per-base affine digit permutation,
    including the permuted-zero tail term b^-dc · (1/b)·π(0)/(1 − 1/b)."""
    base = PRIMES[dim]
    a = int(perms[dim, 0])
    c = int(perms[dim, 1])
    r = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    w = Float(1.0 / base)
    digit_count = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for _ in range(_digits_for(base, max_index)):
        nz = x != 0
        digit = x % base
        x = x // base
        pd = (digit * a + c) % base  # affine permutation (p < 2^13)
        r = torch.where(nz, r + pd.to(torch.float32) * float(w), r)
        digit_count = torch.where(nz, digit_count + 1, digit_count)
        w = w * Float(1.0 / base)
    inv_base = Float(1.0 / base)
    # the base as a 0-d tensor made on x's device: torch.tensor(..., device=)
    # would copy it from the host, a sync that a CUDA graph cannot record
    inv_base_n = torch.pow(
        torch.full((), float(base), dtype=torch.float32, device=x.device),
        -digit_count.to(torch.float32),
    )
    tail = inv_base * Float(float(c)) / (Float(1.0) - inv_base)  # π(0) = c
    return r + inv_base_n * float(tail)


def _hash_u32(x, salt):
    """Counter-based hash for dims past the prime table (xxhash-style
    mixing); uint32 wraparound via int64 masking."""
    x = x ^ (salt & _U32)
    x = (x * 0x85EBCA6B) & _U32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _U32
    x = x ^ (x >> 16)
    return x


def halton_sample(indices, dim: int, cfg: HaltonConfig, perms):
    """Sample value for static `dim` at each Halton index. indices: (...,)
    int64 → f32 in [0, 1) (HaltonSampler::get_sample + get_1d clamp)."""
    mi = cfg.max_index
    if dim == 0:
        r = radical_inverse(indices // cfg.scale_x, 2,
                            max_index=-(-mi // cfg.scale_x))
    elif dim == 1:
        r = radical_inverse(indices // cfg.scale_y, 3,
                            max_index=-(-mi // cfg.scale_y))
    elif dim < MAX_DIMS:
        r = scrambled_radical_inverse(indices, dim, perms, max_index=mi)
    else:
        salt = (0x9E3779B9 * (dim + 1) + cfg.seed) & _U32
        r = _hash_u32(indices, salt).to(torch.float32) * float(2.0**-32)
    return torch.clamp(r, max=ONE_MINUS_EPS)


def halton_sample_2d(indices, dim: int, cfg: HaltonConfig, perms):
    return torch.stack(
        [
            halton_sample(indices, dim, cfg, perms),
            halton_sample(indices, dim + 1, cfg, perms),
        ],
        dim=-1,
    )
