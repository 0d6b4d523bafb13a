"""The port's copy of the `jax.random` draws the reference makes, in numpy.

The reference draws every fault, probe and test vector from `jax.random`
(threefry2x32, with `jax_threefry_partitionable` on, the default of jax 0.9).
The chip machine has no jax, so the port makes the same draws here, bit for
bit (tests/test_torch_prng.py holds each primitive against `jax.random`):

  PRNGKey(seed)                  the legacy raw key, a (2,) uint32 array
  split(key, num)                (..., num, 2): per-element counters 0..num-1
  random_bits(key, shape)        (..., *shape) uint32 words
  randint(key, shape, lo, hi, dtype)
                                 jax's two-draw multiply-and-reduce, int32
                                 (the reference's default) or uint32
  uniform / bernoulli            float32 in [0, 1) from the top 23 bits
  permutation / choice           rounds of a stable sort on random 32-bit keys
                                 (choice is jax's without replacement)

A key is a uint32 array whose last axis has length 2.  Every function takes
any leading key axes, so T per-trial keys draw in one call: what
`jax.vmap` over keys gives, the function applied to each key alone.  The draws
are made on the host; a campaign moves them to its device once.

`random_bits_on`, `randint_on` and `choice_on` make the same draws on a torch
device (the threefry rounds in int64 tensor ops, a stable `torch.sort`), for
campaigns whose draws are large enough to set their wall on the host: the
reduction campaigns draw tens of millions of words, the control campaign at
n = 4096 sixteen million.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

Shape = Union[int, Sequence[int]]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_FLOAT_ONE_BITS = np.uint32(0x3F800000)          # float32 1.0
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1
_UINT32_MAX = (1 << 32) - 1


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if np.ndim(shape) == 0 else tuple(int(d) for d in shape)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x1, x2) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash of jax (`prng._threefry2x32_lowering`): 20
    rounds with key injections after every four; all arguments uint32 and
    broadcast against each other."""
    k1, k2 = np.asarray(k1, np.uint32), np.asarray(k2, np.uint32)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = np.asarray(x1, np.uint32) + ks[0]
    x1 = np.asarray(x2, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` with 64-bit types off: the seed is taken as
    an int32, whose shift right by 32 is 0, so the key is [0, seed mod 2^32]."""
    seed = int(seed)
    if not _INT32_MIN <= seed <= _INT32_MAX:
        raise ValueError(f"seed {seed} does not fit int32, as jax takes it without 64-bit types")
    return np.array([0, seed & _UINT32_MAX], dtype=np.uint32)


def _hash_counts(key: np.ndarray, shape: Tuple[int, ...]) -> Tuple[np.ndarray, np.ndarray]:
    """threefry(key, iota) over `shape`, the partitionable form: element i of
    the row-major iota is the 64-bit counter (i >> 32, i & (2^32 - 1)).
    Returns two (keys, size) arrays, one row per leading key (kept 2-d, so
    numpy wraps uint32 as arrays do, never as scalars)."""
    key = np.asarray(key, np.uint32)
    idx = np.arange(math.prod(shape), dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(_UINT32_MAX)).astype(np.uint32)
    return threefry2x32(key[..., 0].reshape(-1, 1), key[..., 1].reshape(-1, 1), hi, lo)


def split(key: np.ndarray, num: Shape = 2) -> np.ndarray:
    """`jax.random.split`: keys (..., 2) -> (..., *num, 2)."""
    num = _shape(num)
    b1, b2 = _hash_counts(key, num)
    return np.stack([b1, b2], axis=-1).reshape(np.shape(key)[:-1] + num + (2,))


def _bits(key: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    b1, b2 = _hash_counts(key, shape)
    return b1 ^ b2


def random_bits(key: np.ndarray, shape: Shape = ()) -> np.ndarray:
    """32 random bits per element (`prng.threefry_random_bits`, width 32):
    (..., *shape) uint32."""
    shape = _shape(shape)
    return _bits(key, shape).reshape(np.shape(key)[:-1] + shape)


def _clip_bound(v: int, dtype) -> int:
    """jax's `_convert_and_clip_integer` of a Python int bound (an int32 with
    64-bit types off) into the sampling dtype."""
    if not _INT32_MIN <= v <= _INT32_MAX:
        raise ValueError(f"bound {v} does not fit int32, as jax takes it without 64-bit types")
    info = np.iinfo(dtype)
    return min(max(v, max(int(info.min), _INT32_MIN)), min(int(info.max), _INT32_MAX))


def randint(key: np.ndarray, shape: Shape, minval: int, maxval: int,
            dtype=np.int32) -> np.ndarray:
    """`jax.random.randint` for dtype int32 or uint32 and int bounds:
    (..., *shape) of `dtype`.

    As jax does: two keys from split(key), 32 bits from each, and
    offset = ((hi mod span)·m + lo mod span) mod span with
    m = (2^16 mod span)^2 mod span, every product wrapping in uint32 (for
    span > 2^16, m wraps to 0 and only the low draw counts)."""
    dtype = np.dtype(dtype)
    if dtype not in (np.dtype(np.int32), np.dtype(np.uint32)):
        raise TypeError(f"randint takes int32 or uint32 here, got {dtype}")
    shape = _shape(shape)
    lo_v, hi_v = _clip_bound(int(minval), dtype), _clip_bound(int(maxval), dtype)
    k = split(key)
    higher = _bits(k[..., 0, :], shape)
    lower = _bits(k[..., 1, :], shape)
    span = np.uint32(1 if hi_v <= lo_v else (hi_v - lo_v) & _UINT32_MAX)
    mult = np.uint32((1 << 16) % int(span))
    mult = np.uint32((int(mult) * int(mult) & _UINT32_MAX) % int(span))
    offset = (higher % span) * mult + lower % span
    offset = offset % span
    out = ((np.int64(lo_v) + offset.astype(np.int64)) & _UINT32_MAX).astype(np.uint32)
    out = out.reshape(np.shape(key)[:-1] + shape)
    return out.view(np.int32) if dtype == np.int32 else out


def uniform(key: np.ndarray, shape: Shape = ()) -> np.ndarray:
    """`jax.random.uniform` in float32 on [0, 1): the top 23 bits as the
    mantissa of a float in [1, 2), minus 1."""
    shape = _shape(shape)
    bits = _bits(key, shape)
    u = ((bits >> np.uint32(9)) | _FLOAT_ONE_BITS).view(np.float32) - np.float32(1.0)
    return u.reshape(np.shape(key)[:-1] + shape)


def bernoulli(key: np.ndarray, p: float = 0.5, shape: Shape = ()) -> np.ndarray:
    """`jax.random.bernoulli(key, p, shape)` (mode 'low'): uniform < p in float32."""
    return uniform(key, shape) < np.float32(p)


def _rounds(n: int) -> int:
    """Sort rounds of jax's permutation of n: ceil(3·ln n / ln(2^32 - 1))."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def permutation(key: np.ndarray, n: int) -> np.ndarray:
    """`jax.random.permutation(key, n)`: arange(n) (int32) through
    ceil(3·ln n / ln(2^32 - 1)) rounds; each round splits the key, draws a
    32-bit sort key per element from the second half and sorts stably by it
    (`lax.sort_key_val`, stable, so equal sort keys keep their order).
    Returns (..., n) int32."""
    key = np.asarray(key, np.uint32)
    x = np.broadcast_to(np.arange(n, dtype=np.int32), key.shape[:-1] + (n,))
    for _ in range(_rounds(n)):
        k = split(key)
        key, sub = k[..., 0, :], k[..., 1, :]
        order = np.argsort(random_bits(sub, n), axis=-1, kind="stable")
        x = np.take_along_axis(x, order, axis=-1)
    return x


def choice(key: np.ndarray, n: int, shape: Shape) -> np.ndarray:
    """`jax.random.choice(key, n, shape, replace=False)` of arange(n): the
    first prod(shape) entries of permutation(key, n).  Returns (..., *shape)
    int32."""
    shape = _shape(shape)
    k = math.prod(shape)
    if k > n:
        raise ValueError(f"cannot take {k} of {n} without replacement")
    key = np.asarray(key, np.uint32)
    return permutation(key, n)[..., :k].reshape(key.shape[:-1] + shape)


# ---------------------------------------------------------------------------
# The same draws on a torch device

_M32 = 0xFFFFFFFF


def _threefry_on(k1: torch.Tensor, k2: torch.Tensor, x1, x2: torch.Tensor):
    """`threefry2x32` on int64 tensors holding 32-bit words."""
    ks = (k1, k2, k1 ^ k2 ^ int(_PARITY))
    x0 = (x1 + ks[0]) & _M32
    x1 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def random_bits_on(key: np.ndarray, shape: Shape, device) -> torch.Tensor:
    """`random_bits` computed on `device`: (..., *shape) int64 words."""
    shape = _shape(shape)
    size = math.prod(shape)
    if size >> 32:
        raise ValueError("a draw of 2^32 words or more per key is not supported")
    key = np.asarray(key, np.uint32)
    k = torch.from_numpy(key.reshape(-1, 2).astype(np.int64)).to(device)
    b1, b2 = _threefry_on(k[:, :1], k[:, 1:], 0, torch.arange(size, device=k.device))
    return (b1 ^ b2).reshape(key.shape[:-1] + shape)


def randint_on(key: np.ndarray, shape: Shape, minval: int, maxval: int, device) -> torch.Tensor:
    """`randint` (int32 or uint32 bounds alike, values in [minval, maxval))
    computed on `device`: (..., *shape) int64.  The uint32 product of the
    reference wraps only where span > 2^16, and there m = 0."""
    if int(minval) < 0:
        raise ValueError("randint_on takes bounds >= 0")
    shape = _shape(shape)
    lo_v, hi_v = _clip_bound(int(minval), np.uint32), _clip_bound(int(maxval), np.uint32)
    k = split(key)
    higher = random_bits_on(k[..., 0, :], shape, device)
    lower = random_bits_on(k[..., 1, :], shape, device)
    span = 1 if hi_v <= lo_v else hi_v - lo_v
    mult = ((1 << 16) % span) ** 2 % (1 << 32) % span
    return lo_v + (((higher % span) * mult + lower % span) & _M32) % span


def choice_on(key: np.ndarray, n: int, shape: Shape, device) -> torch.Tensor:
    """`choice` (without replacement) computed on `device`: the permutation's
    rounds as stable sorts of `random_bits_on` words.  (..., *shape) int64."""
    shape = _shape(shape)
    k = math.prod(shape)
    if k > n:
        raise ValueError(f"cannot take {k} of {n} without replacement")
    key = np.asarray(key, np.uint32)
    lead = key.shape[:-1]
    x = torch.arange(n, device=device).expand(lead + (n,))
    for _ in range(_rounds(n)):
        ks = split(key)
        key, sub = ks[..., 0, :], ks[..., 1, :]
        order = torch.sort(random_bits_on(sub, n, device), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x[..., :k].reshape(lead + shape)
