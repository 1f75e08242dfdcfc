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
  clamps below at ``minval``;
* a float32 standard normal is ``sqrt(2)·erf_inv(u)`` of a uniform u on
  ``[nextafter(-1, 0), 1)``.  ``erf_inv`` is XLA's single-precision
  polynomial (``w = -log1p(-u²)``, one branch of 9 coefficients below
  ``w = 5`` and one above), each Horner step one fused multiply-add, and
  ``log1p`` is XLA's own CPU expansion: a Cephes rational function below
  ``|x| = sqrt(2) - 1`` and XLA's Cephes ``log`` of ``1 + x`` above, with
  the multiply-adds the CPU backend fuses.  Scipy's double ``erfinv``
  rounded to float32 is up to 82 ulp off; this is bitwise.

Only the draws the initialisers need are here.  The search's per-chain draws
stay on torch generators.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["threefry2x32", "key", "split", "random_bits", "uniform",
           "glorot", "normal"]

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


def _fma_f32(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as XLA's CPU backend fuses it
    (scalars or arrays of one shape).

    The float32 product is exact in float64; the float64 sum is rounded to
    odd (kept odd when inexact), so its rounding to float32 is the rounding
    of the exact value.
    """
    p = np.asarray(a, np.float32).astype(np.float64) * np.asarray(
        b, np.float32).astype(np.float64)
    c64 = np.asarray(c, np.float32).astype(np.float64)
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


_F32 = np.float32
#: XLA's CPU ``log`` (Cephes): the polynomial's coefficients p0..p8, and
#: ln 2 split in two
_LOG_P = tuple(_F32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = _F32(-2.12194440e-4), _F32(0.693359375)
#: XLA's ``log1p`` below sqrt(2) - 1 (Cephes), highest power last
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
#: XLA's single-precision ``erf_inv``, below and above w = 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _log_f32(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``log`` of positive normal ``x`` (Cephes ``logf``
    with its multiply-adds fused)."""
    bits = np.maximum(x, np.uint32(0x00800000).view(_F32)).view(np.uint32)
    e = (bits >> np.uint32(23)).astype(np.int32) - 0x7F
    m = ((bits & np.uint32(0x807FFFFF))
         | np.uint32(0x3F000000)).view(_F32)            # mantissa in [.5, 1)
    e = _F32(1) + e.astype(_F32)
    low = m < _F32(0.707106781186547524)
    t = (m - _F32(1)) + np.where(low, m, _F32(0))
    e = e - np.where(low, _F32(1), _F32(0))
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = _fma_f32(_fma_f32(t, p[0], p[1]), t, p[2])
    y1 = _fma_f32(_fma_f32(t, p[3], p[4]), t, p[5])
    y2 = _fma_f32(_fma_f32(t, p[6], p[7]), t, p[8])
    y = _fma_f32(_fma_f32(y, x3, y1), x3, y2)
    y = _fma_f32(y, x3, _LOG_Q1 * e)
    t = _fma_f32(_F32(-0.5), x2, t) + y
    return _fma_f32(_LOG_Q2, e, t)


def _log1p_f32(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``log1p`` of ``x`` in (-1, 0]."""
    xs = x * x
    num = np.zeros_like(x)
    den = np.zeros_like(x)
    for cn, cd in zip(_LOG1P_NUM, _LOG1P_DEN):
        num = _fma_f32(num, x, _F32(cn))
        den = _fma_f32(den, x, _F32(cd))
    small = x + _fma_f32(_F32(-0.5), xs, (x * xs) * (num / den))
    with np.errstate(divide="ignore", invalid="ignore"):
        large = _log_f32(x + _F32(1))
    return np.where(np.abs(x) < _F32(0.41421356237309504880), small, large)


def _erf_inv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv`` of ``x`` in (-1, 1)."""
    w = -_log1p_f32(x * -x)
    lt = w < _F32(5)
    with np.errstate(invalid="ignore"):
        w = np.where(lt, w - _F32(2.5), np.sqrt(w) - _F32(3))
    p = np.where(lt, _F32(_ERFINV_LT5[0]), _F32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma_f32(p, w, np.where(lt, _F32(a), _F32(b)))
    return p * x


def normal(k: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.normal(k, shape)`` (float32), bitwise on XLA's CPU."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = uniform(k, shape, lo, 1.0)
    return _F32(np.sqrt(2)) * _erf_inv_f32(u)
