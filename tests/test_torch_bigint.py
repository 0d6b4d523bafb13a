"""Port parity: rfhe_tpu_torch.ops.bigint against rfhe_tpu.ops.bigint on
random words, tolerance 0 (every output word equal), truncating widths and
out-of-domain Barrett inputs included."""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfhe_tpu.numth import barrett_constants, find_prime_with_bitlen, next_prime_ge
from rfhe_tpu.ops import bigint as ref
from rfhe_tpu.ops import u32 as ref_u32
from rfhe_tpu_torch.ops import bigint, modarith

torch.set_num_threads(1)

EXTREMES = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF], dtype=np.uint32)


def words(seed, shape):
    """uint32 words from numpy: uniform, with extreme words mixed in."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    pick = rng.random(shape) < 0.15
    w[pick] = rng.choice(EXTREMES, int(pick.sum()))
    return w


def same(port, reference):
    a = port.cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    b = np.asarray(reference).astype(np.int64)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a.astype(np.int64), b)


def pair(w):
    return torch.from_numpy(w.astype(np.int64)), jnp.asarray(w)


@pytest.mark.parametrize("L", [1, 3, 5])
def test_add_sub_cmp(L):
    (a, ja), (b, jb) = pair(words(L, (64, L))), pair(words(L + 10, (64, L)))
    same(bigint.add(a, b), ref.add(ja, jb))
    d, borrow = bigint.sub(a, b)
    rd, rborrow = ref.sub(ja, jb)
    same(d, rd)
    same(borrow, rborrow)
    same(bigint.cmp_ge(a, b), ref.cmp_ge(ja, jb))
    same(bigint.cmp_ge(a, a), ref.cmp_ge(ja, ja))


@pytest.mark.parametrize("La, Lb, out", [(2, 2, None), (3, 2, None), (2, 2, 3), (3, 2, 3),
                                         (5, 2, 3), (2, 1, 4), (4, 3, 2), (1, 1, 1)])
def test_mul(La, Lb, out):
    (a, ja), (b, jb) = pair(words(La * 7 + Lb, (48, La))), pair(words(La + 99, (48, Lb)))
    same(bigint.mul(a, b, out), ref.mul(ja, jb, out))
    # a constant operand broadcast over the rows
    c = words(5, (Lb,))
    same(bigint.mul(a, torch.from_numpy(c.astype(np.int64)), out), ref.mul(ja, jnp.asarray(c), out))


@pytest.mark.parametrize("bits, out", [(0, None), (1, None), (31, 2), (32, None), (37, 3),
                                       (74, 2), (100, 4), (150, 1)])
def test_shift_right(bits, out):
    a, ja = pair(words(bits, (40, 5)))
    same(bigint.shift_right(a, bits, out), ref.shift_right(ja, bits, out))


def test_xor_bit_bit_length_mask():
    a, ja = pair(words(3, (60, 4)))
    pos = np.random.default_rng(4).integers(0, 140, 60).astype(np.uint32)
    same(bigint.xor_bit(a, torch.from_numpy(pos.astype(np.int64))), ref.xor_bit(ja, jnp.asarray(pos)))
    a[::7] = 0
    ja = jnp.asarray(a.numpy().astype(np.uint32))
    same(bigint.bit_length(a), ref.bit_length(ja))
    nb = np.random.default_rng(5).integers(0, 140, 60).astype(np.uint32)
    same(bigint.mask_to_bits(a, torch.from_numpy(nb.astype(np.int64))),
         ref.mask_to_bits(ja, jnp.asarray(nb)))


@pytest.mark.parametrize("w", [2, 3, 12, 24, 31, 32])
def test_fold_mod(w):
    a, ja = pair(words(w, (80, 5)))
    same(bigint.fold_mod(a, w), ref.fold_mod(ja, w))
    ones = np.full((2, 3), 0xFFFFFFFF, dtype=np.uint32)
    same(bigint.fold_mod(torch.from_numpy(ones.astype(np.int64)), w), ref.fold_mod(jnp.asarray(ones), w))


@pytest.mark.parametrize("s", [2, 4, 10, 17, 30])
def test_fold_2s1(s):
    a, ja = pair(words(s + 40, (80, 4)))
    same(bigint.fold_2s1(a, s), ref.fold_2s1(ja, s))


@pytest.mark.parametrize("m", [3, 1009, 65521, 12289 * 5, 2147483647])
def test_mod_small(m):
    a, ja = pair(words(m % 97, (50, 3)))
    same(bigint.mod_small(a, m), ref.mod_small(ja, m))


def test_cond_sub_and_fit():
    a, ja = pair(words(8, (40, 3)))
    m = words(9, (3,))
    m[2] >>= 1
    same(bigint.cond_sub_big(a, torch.from_numpy(m.astype(np.int64))),
         ref.cond_sub_big(ja, jnp.asarray(m)))
    for limbs in (1, 3, 5):
        same(bigint._fit(a, limbs), ref._fit(ja, limbs))


@pytest.mark.parametrize("pbits, raw_limbs, out", [(37, 3, 2), (37, 2, 2), (30, 2, 1), (61, 4, 2)])
def test_barrett_reduce_big(pbits, raw_limbs, out):
    """Inputs of every width: below q² (exact) and, as the reduction
    campaigns' `_uniform_below` hands it 2·bitlen(p) whole words, far above."""
    p = find_prime_with_bitlen(pbits, random.Random(42))
    mu, k = barrett_constants(p)
    a, ja = pair(words(pbits + raw_limbs, (128, raw_limbs)))
    got = bigint.barrett_reduce_big(a, p, mu, k, out)
    same(got, ref.barrett_reduce_big(ja, p, mu, k, out))
    if pbits == 37 and raw_limbs == 3:
        vals = bigint.to_ints(got)
        assert max(vals) >= p              # the reference's words are not reduced here


def test_barrett_final_constants_and_sum_mod_big():
    Q = next_prime_ge(1 << 36)
    for n in (1, 5, 64):
        raw = words(n, (3, n, 2))
        raw[..., 1] &= 0xF                  # values below 2^36 < Q
        a, ja = pair(raw)
        same(bigint.sum_mod_big(a, Q), ref.sum_mod_big(ja, Q))
        same(bigint.sum_mod_big(a.transpose(0, 1), Q, axis=0),
             ref.sum_mod_big(jnp.swapaxes(ja, 0, 1), Q, axis=0))


def test_int_roundtrip_and_mulhi():
    for x, limbs in ((0, 1), (123456789012345678901234, 3), ((1 << 128) - 1, 4)):
        w = bigint.from_int(x, limbs)
        assert bigint.to_int(w) == x == ref.to_int(ref.from_int(x, limbs))
        same(w, ref.from_int(x, limbs))
    with pytest.raises(ValueError):
        bigint.from_int(1 << 64, 2)
    (a, ja), (b, jb) = pair(words(11, (100,))), pair(words(12, (100,)))
    same(modarith.mulhi32(a, b), ref_u32.mulhi32(ja, jb))
    assert bigint.to_ints(torch.stack([bigint.from_int(7, 2), bigint.from_int(1 << 40, 2)])) == [7, 1 << 40]
