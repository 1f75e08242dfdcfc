"""JAX's threefry-2x32 key stream in numpy, for the reference's initial weights.

The reference draws every initial weight of ``HSDAG.init`` from
``jax.random`` keys: a Glorot-uniform matrix per layer, biases at zero.  This
module reproduces those draws bit for bit without JAX, so the port's
``HSDAG(cfg).init`` for seed ``s`` holds the weights the reference's search
for seed ``s`` starts from.  It follows the *partitionable* layout of
``jax.random`` (``jax_threefry_partitionable``, the default since JAX 0.5):

* a key is two uint32 words; ``key(seed)`` is ``(0, seed)`` for a
  non-negative 32-bit seed, as ``jax.random.PRNGKey`` gives it;
* ``split(k, n)[i]`` is the threefry block of ``k`` on the counter
  ``(hi(i), lo(i))`` — both output words form the new key;
* the 32 random bits of element ``i`` (row-major) of a draw are the XOR of
  the two words of the block on the counter ``(hi(i), lo(i))``;
* a float32 uniform keeps the top 23 of those bits as the mantissa of a
  number u in [1, 2), subtracts 1, takes ``(u - 1)·(maxval − minval) +
  minval`` as one fused multiply-add (XLA's CPU backend fuses it; a
  separate product and sum differ in the last bit about half the time) and
  clamps below at ``minval``.

Only the draws the initialisers need are here.  The search's per-chain draws
stay on torch generators.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["threefry2x32", "key", "split", "random_bits", "uniform",
           "glorot"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The threefry-2x32 block (20 rounds) of key ``k`` (2,) uint32 on the
    counter words ``x0``, ``x1`` (uint32 arrays of one shape) → two uint32
    arrays of that shape."""
    k0, k1 = (np.uint32(w) for w in np.asarray(k, np.uint32))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _counters(n: int):
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), i.astype(np.uint32)


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**32)."""
    if not 0 <= int(seed) < 2 ** 32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return np.array([0, int(seed)], np.uint32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)`` → (num, 2) uint32."""
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(k, *_counters(num))
    return np.stack([b0, b1], axis=1)


def random_bits(k: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """32 random bits per element of ``shape`` (uint32)."""
    n = int(np.prod(shape, dtype=np.int64))
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(k, *_counters(n))
    return (b0 ^ b1).reshape(tuple(shape))


def _fma_f32(a: np.ndarray, b: np.float32, c: np.float32) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as XLA's CPU backend fuses it.

    The float32 product is exact in float64; the float64 sum is rounded to
    odd (kept odd when inexact), so its rounding to float32 is the rounding
    of the exact value.
    """
    p = a.astype(np.float64) * np.float64(b)
    c64 = np.float64(c)
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    even = (s.view(np.uint64) & np.uint64(1)) == 0
    s = np.where((err != 0) & even, np.nextafter(s, s + err), s)
    return s.astype(np.float32)


def uniform(k: np.ndarray, shape: Sequence[int], minval, maxval
            ) -> np.ndarray:
    """``jax.random.uniform(k, shape, jnp.float32, minval, maxval)``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(k, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma_f32(floats, hi - lo, lo))


def glorot(k: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """The reference's ``_glorot``: Uniform(±sqrt(6 / (fan_in + fan_out)))
    with the limit rounded to float32 before its square root, as
    ``jnp.sqrt`` of a Python float takes it."""
    lim = np.sqrt(np.float32(6.0 / (shape[0] + shape[-1])))
    return uniform(k, shape, -lim, lim)
