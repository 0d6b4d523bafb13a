"""Fault campaigns on device buffers: bit flips injected straight into the
tensors around real kernels, clean-vs-faulty differentials, and the
clean-vs-clean rerun that catches genuine silent hardware faults.

Counterpart of `rfhe_tpu/faults/hardware.py` (the role of the reference's
reliability_test/ntt_test.cu, ntt_real_test.cu and dotprod_test.cu):

  ntt_flip_campaign      batched forward NTT; flip `num_flips` bits in each
                         of `num_target_symbols` input words, rerun, report
                         Hamming / bit-error / symbol-error counts
  ntt_real_test          the same NTT twice on the same input, diffed: any
                         difference is a silent hardware fault
  ciphertext_flip        xor one bit of a ciphertext residue buffer
  dotprod_fault_campaign the encrypted BGV dot product with one ciphertext
                         word corrupted, error counts against the plaintext
  dotprod_stress         many clean dot products with the same keys

The NTT campaigns run the port's `NttPlan`, whose forward transform launches
the hand-written kernels on a GPU.  The reference runs its `StackedNttPlan`:
the same linear map in Montgomery form with another order of slots
(bit-reversed there, nu here), so Hamming distances and symbol errors, which
do not depend on the order, agree exactly, and the arrays agree through the
slot permutation `NttPlan.tables.pos` (tests/test_torch_hardware.py).  The
draws are the reference's (`prng`, numpy).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from .. import prng
from ..device import to_torch
from ..ops.modarith import M32, popcount32
from ..ops.ntt import NttPlan


@dataclass
class ErrorStats:
    hamming_bits: int
    total_bits: int
    symbol_errors: int
    total_symbols: int

    @property
    def bit_error_rate(self) -> float:
        return self.hamming_bits / max(1, self.total_bits)

    @property
    def symbol_error_rate(self) -> float:
        return self.symbol_errors / max(1, self.total_symbols)


def compare_buffers(clean: torch.Tensor, faulty: torch.Tensor,
                    bits_per_symbol: int = 32) -> ErrorStats:
    """Hamming and symbol-error counts between two buffers of words: the
    popcount of the XOR of their low 32 bits."""
    x = (clean ^ faulty) & M32
    return ErrorStats(hamming_bits=int(popcount32(x).sum()),
                      total_bits=clean.numel() * bits_per_symbol,
                      symbol_errors=int((x != 0).sum()), total_symbols=clean.numel())


def flip_bits_host_style(x: torch.Tensor, key, num_flips: int, num_target_symbols: int,
                         bitwidth: int = 32) -> torch.Tensor:
    """Flip `num_flips` random bits (< bitwidth; a bit drawn twice flips
    back) in each of `num_target_symbols` distinct random words."""
    k = prng.split(key)
    idx = prng.choice(k[0], x.numel(), (num_target_symbols,))
    bits = prng.randint(k[1], (num_target_symbols, num_flips), 0, bitwidth, np.uint32)
    masks = np.zeros(num_target_symbols, dtype=np.int64)
    for f in range(num_flips):
        masks ^= np.int64(1) << bits[:, f].astype(np.int64)
    flat = x.reshape(-1).clone()
    idx_t = torch.from_numpy(idx.astype(np.int64)).to(x.device)
    flat[idx_t] ^= torch.from_numpy(masks).to(x.device)
    return flat.reshape(x.shape)


def _ntt_input(plan: NttPlan, batch: int, key) -> Tuple[torch.Tensor, int]:
    """Words in [0, min q) of shape (batch, L, n), drawn on the host as the
    reference draws them (uint32 randint)."""
    qmax = min(plan.primes)
    x = prng.randint(key, (batch, plan.L, plan.n), 0, qmax, np.uint32)
    return to_torch(x, plan.device), qmax


def ntt_flip_campaign(plan: NttPlan, batch: int, num_flips: int, num_target_symbols: int,
                      seed: int = 0) -> Tuple[ErrorStats, Dict]:
    """Clean forward NTT against the NTT of a bit-flipped input.  Flips stay
    below bit_length(min q), so a word may reach or pass the q of a larger
    limb; the transform takes it as the word mod q, as the reference's does."""
    k_data, k_flip = prng.split(prng.PRNGKey(seed))
    x, qmax = _ntt_input(plan, batch, k_data)
    clean = plan.fwd(x)
    x_f = flip_bits_host_style(x, k_flip, num_flips, num_target_symbols,
                               bitwidth=int(qmax).bit_length())
    faulty = plan.fwd(x_f)
    info = {"input_symbols_corrupted": int((x != x_f).sum()),
            "batch": batch, "L": plan.L, "n": plan.n}
    return compare_buffers(clean, faulty), info


def ntt_real_test(plan: NttPlan, batch: int, seed: int = 0) -> ErrorStats:
    """Clean-vs-clean: the same forward NTT twice on the device, diffed.
    Nonzero Hamming is a genuine silent hardware fault."""
    x, _ = _ntt_input(plan, batch, prng.PRNGKey(seed))
    a = plan.fwd(x)
    b = plan.fwd(x)
    return compare_buffers(a, b)


def ciphertext_flip(ct_data: torch.Tensor, global_bit_index: int,
                    word_bits: int = 32) -> torch.Tensor:
    """Flip one absolute bit of a ciphertext residue buffer."""
    word, bit = divmod(global_bit_index, word_bits)
    flat = ct_data.reshape(-1).clone()
    flat[word] ^= 1 << bit
    return flat.reshape(ct_data.shape)


def dotprod_fault_campaign(bgv_ctx, bits_per_symbol: int, num_symbols: int,
                           seed: int = 0, exact_decrypt: bool = False) -> Dict:
    """The encrypted BGV dot product with `bits_per_symbol` flips (bits
    0-29) in each of `num_symbols` words of ct1's c0, in NTT form: the
    product's decryption and the folded dot product against the plaintext.
    A flipped word may lie at or above its q; the product reduces it, as
    the reference's does.

    Decryption is the reference's `decrypt_decode`, whose CRT is exact for
    centered coefficients below 2^62.  The product of two fresh ciphertexts
    passes that at N=16384 with t of 20 bits (about 2^63), so there even
    the clean product decodes wrong; exact_decrypt=True decodes through the
    host's exact CRT (`decrypt_coeffs_t(exact=True)`) instead, which gives
    the same words wherever the window holds.  A faulty product's error is a
    random value mod Q, outside the window at any ring, so its decoded words
    (and the bit errors counted from them) depend on the CRT taken."""
    from ..fhe.ckks import Ciphertext
    from ..fhe.rns import RnsPoly
    from ..models.dotprod import dot_product_bgv
    rng = np.random.default_rng(seed)
    t = bgv_ctx.t
    shape = (2, bgv_ctx.params.n // 2)
    m1 = rng.integers(0, t, shape, dtype=np.uint32)
    m2 = rng.integers(0, t, shape, dtype=np.uint32)
    ct1 = bgv_ctx.encrypt(bgv_ctx.encode(m1))
    ct2 = bgv_ctx.encrypt(bgv_ctx.encode(m2))
    data = ct1.c[0].data
    for _ in range(num_symbols):
        word = int(rng.integers(0, data.numel()))
        for _ in range(bits_per_symbol):
            data = ciphertext_flip(data, word * 32 + int(rng.integers(0, 30)))
    ct1_f = Ciphertext([RnsPoly(data, True), ct1.c[1]], 1.0)
    if exact_decrypt:
        decrypt = lambda ct: bgv_ctx.decode(bgv_ctx.decrypt_coeffs_t(ct, exact=True))
    else:
        decrypt = bgv_ctx.decrypt_decode

    # the product, decrypted before the fold
    d_clean = decrypt(bgv_ctx.multiply_relin(ct1, ct2))
    d_fault = decrypt(bgv_ctx.multiply_relin(ct1_f, ct2))
    expect = (m1.astype(np.uint64) * m2) % t
    diff = (np.asarray(d_fault).astype(np.uint64) ^ expect).reshape(-1)
    bit_err = int(sum(bin(int(v)).count("1") for v in diff[diff != 0]))
    # the whole dot product
    full_clean = decrypt(dot_product_bgv(bgv_ctx, ct1, ct2))
    full_fault = decrypt(dot_product_bgv(bgv_ctx, ct1_f, ct2))
    expected_dot = int((m1.astype(object) * m2.astype(object)).sum()) % t
    return {
        "symbol_errors": int((d_fault != expect).sum()),
        "total_symbols": int(np.prod(shape)),
        "bit_errors": bit_err,
        "clean_product_ok": bool((d_clean == expect).all()),
        "clean_dot_ok": int(full_clean[0, 0]) == expected_dot,
        "faulty_dot_value": int(full_fault[0, 0]),
        "expected_dot": expected_dot,
        "dot_hamming": bin(int(full_fault[0, 0]) ^ expected_dot).count("1"),
    }


def dotprod_stress(bgv_ctx, iterations: int = 20, seed: int = 0) -> Dict:
    """Many encrypted dot products with the same keys, each against the
    plaintext result; any mismatch is a silent fault."""
    from ..models.dotprod import dot_product_bgv
    rng = np.random.default_rng(seed)
    t = bgv_ctx.t
    shape = (2, bgv_ctx.params.n // 2)
    failures = 0
    for _ in range(iterations):
        m1 = rng.integers(0, t, shape, dtype=np.uint32)
        m2 = rng.integers(0, t, shape, dtype=np.uint32)
        ct = dot_product_bgv(bgv_ctx, bgv_ctx.encrypt(bgv_ctx.encode(m1)),
                             bgv_ctx.encrypt(bgv_ctx.encode(m2)))
        got = int(bgv_ctx.decrypt_decode(ct)[0, 0])
        failures += got != int((m1.astype(object) * m2.astype(object)).sum()) % t
    return {"iterations": iterations, "failures": failures}
