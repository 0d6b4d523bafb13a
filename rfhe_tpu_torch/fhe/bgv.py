"""BGV scheme layer: batch encoding, encrypt/decrypt, evaluator.

Counterpart of `rfhe_tpu/fhe/bgv.py`, the surface the reference's
dot-product campaign consumes: batch encode, public-key encrypt, multiply,
relinearize, mod_switch_to_next, rotate rows and columns through Galois
keys, decrypt.  With the same parameters and seed, keys and every
ciphertext array equal the reference's (tests/test_torch_bgv.py).

Batching: t is an NTT prime ≡ 1 (mod 2n), so the slots are the negacyclic
NTT domain mod t, arranged as a 2×(n/2) matrix (row 0 ↔ exponents 5^j,
row 1 ↔ −5^j).  The reference reads them through its Pease plan's slot
order; the port's t plan (`NttPlan`, which launches the CUDA kernels on a
card) has another order, so `_slot_map` is built on the port's order and
names the same evaluation points: the coefficients and the matrices are the
reference's.  Both plans put the slots in the Montgomery domain (×2^32 mod
t).  `BgvContext` and `fhe.bfv.BfvContext` share `BatchedContext`.  As in the
reference, encrypt, decrypt and the evaluator's keyswitching ops run through
one cached program per (op, signature) (`_jit`, the reference's keys; a CUDA
graph on a card, `utils/jitcache.py`); add, sub and multiply_plain run as
they are, as there.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional

import numpy as np
import torch

from ..device import to_numpy_u32, to_torch
from ..ops.crt64 import Crt64Plan, crt_to_words, words_to_signed
from ..ops.modarith import mont_mul
from ..ops.ntt import NttPlan, _slot_order, split_n
from ..utils.jitcache import GraphPool, HoistedJit, hoisted_jit
from .ckks import Ciphertext, dot_secret, draw_public, encrypt_with, rns_to_signed
from .keys import KeyGen, KeySwitchKey, keyswitch
from .params import make_prime_chain
from .rns import (
    RnsContext, RnsPoly, drop_limb, poly_add, poly_automorphism, poly_intt,
    poly_mul_pointwise, poly_ntt, poly_sub,
)

_R = 1 << 32


@lru_cache(maxsize=8)
def _slot_map(n: int) -> np.ndarray:
    """map[r, j] = the slot of the port's NTT plan holding matrix position
    (r, j): the slot that evaluates at ψ^e, e = 5^j (row 0) or 2n − 5^j
    (row 1) mod 2n (`bgv._slot_map`, there on the Pease plan's order)."""
    nu_inv = _slot_order(n, split_n(n)[0])[1]
    e = np.empty(n // 2, dtype=np.int64)
    g = 1
    for j in range(n // 2):
        e[j] = g
        g = g * 5 % (2 * n)
    return np.stack([nu_inv[(e - 1) // 2], nu_inv[(2 * n - e - 1) // 2]])


def special_primes(params, special_bits: Optional[int] = None,
                   dnum: Optional[int] = None) -> tuple:
    """The keyswitch's special primes of a BGV/BFV chain, as the reference
    picks them: ⌈L/dnum⌉ NTT primes (one for dnum=None) of special_bits (30
    at n ≥ 65536, else 31) that are neither in the chain nor t."""
    if special_bits is None:
        special_bits = 30 if params.n >= 65536 else 31
    n_sp = 1 if dnum is None else -(-params.L // dnum)
    sps = [p for p in make_prime_chain(params.n, [special_bits] * (n_sp + 2))
           if p not in params.moduli and p != params.t][:n_sp]
    if len(sps) != n_sp:
        raise ValueError(f"not enough {special_bits}-bit special primes for dnum={dnum}")
    return tuple(sps)


class BatchedContext:
    """What BGV and BFV share: the chain and its special primes, the t plan,
    the keys (gaussians scaled by `noise_factor`), batch encoding and the
    Galois ops.  `device` is required: nothing picks one."""

    noise_factor = 1          # the gaussians of keys and encryptions are scaled by it
    ks_t: Optional[int] = None   # t of the t-aware mod-down (BGV)

    def __init__(self, params, special_bits: Optional[int], seed: int,
                 dnum: Optional[int], device):
        if dnum is not None and dnum < 1:
            raise ValueError(f"dnum must be a positive integer or None, got {dnum}")
        self.params = params
        self.device = torch.device(device)
        n = params.n
        self.dnum = dnum
        self.specials = special_primes(params, special_bits, dnum)
        self.special = self.specials[0]
        self.ctx = RnsContext.make(n, tuple(params.moduli) + self.specials, self.device)
        self.L = params.L
        self.t = params.t
        self.plan_t = NttPlan.make(n, [params.t], self.device)
        self.keygen = KeyGen(self.ctx, self.L, params.sigma)
        self.rng = np.random.default_rng(seed)
        self.sk = self.keygen.gen_secret(self.rng)
        self.pk = self.keygen.gen_public(self.sk, self.rng, self.noise_factor)
        q, rinv = self.ctx.plan.qb(1), self.ctx.plan.rinvb(1)
        s2 = mont_mul(self.sk.s_ntt, self.sk.s_ntt, q, rinv)
        self.rlk = self.keygen.gen_keyswitch(self.sk, s2, self.rng, self.noise_factor, dnum)
        self._galois: Dict[int, KeySwitchKey] = {}
        self._jits: Dict = {}
        self._graphs = GraphPool()

    def _jit(self, name, fn) -> HoistedJit:
        if name not in self._jits:
            self._jits[name] = hoisted_jit(fn, self._graphs, name)
        return self._jits[name]

    def galois_key(self, g: int) -> KeySwitchKey:
        """Galois key for X -> X^g, drawn from the context's rng on first use."""
        if g not in self._galois:
            s_g = self.sk.s_ntt.index_select(-1, self.ctx.galois_perm_t(g))
            self._galois[g] = self.keygen.gen_keyswitch(self.sk, s_g, self.rng,
                                                         self.noise_factor, self.dnum)
        return self._galois[g]

    # -- batch encode / decode ----------------------------------------------
    def _slots_to_coeffs(self, matrix: np.ndarray) -> torch.Tensor:
        """(2, n/2) ints mod t -> the (n,) coefficients mod t on the device:
        slots into the Montgomery domain, then the inverse NTT mod t."""
        t = self.t
        slots = np.zeros(self.params.n, dtype=np.int64)
        slots[_slot_map(self.params.n).reshape(-1)] = \
            (np.asarray(matrix, dtype=np.uint64).reshape(-1) % t).astype(np.int64)
        sl = to_torch(slots, self.device) * (_R % t) % t
        return self.plan_t.inv(sl[None, :])[0]

    def decode(self, coeffs_t) -> np.ndarray:
        """(n,) coefficients mod t (numpy or a tensor) -> (2, n/2) uint32 slot
        matrix: the NTT mod t, out of the Montgomery domain."""
        t = self.t
        c = coeffs_t if isinstance(coeffs_t, torch.Tensor) else to_torch(coeffs_t, self.device)
        y = self.plan_t.fwd(c.reshape(1, -1)) * pow(_R % t, -1, t) % t
        return to_numpy_u32(y[0])[_slot_map(self.params.n)]

    def decrypt_decode(self, ct: Ciphertext) -> np.ndarray:
        return self.decode(self.decrypt_coeffs_t(ct))

    def _decrypt_impl(self, comps, sk) -> torch.Tensor:
        return self.ctx.plan_at(comps[0].shape[0] - 1).inv(dot_secret(self.ctx, sk.s_ntt, comps))

    def _decrypt_coeffs(self, ct: Ciphertext) -> torch.Tensor:
        """[c(s)]_Q residues (level+1, N), coefficient domain."""
        return self._jit(("decrypt", ct.size, ct.level), self._decrypt_impl)(
            [c.data for c in ct.c], self.sk)

    # -- evaluator ----------------------------------------------------------
    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        assert a.correction == b.correction and a.level == b.level
        return Ciphertext([poly_add(x, y, self.ctx) for x, y in zip(a.c, b.c)], 1.0, a.correction)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        assert a.correction == b.correction and a.level == b.level
        return Ciphertext([poly_sub(x, y, self.ctx) for x, y in zip(a.c, b.c)], 1.0, a.correction)

    def _relinearize_impl(self, ct: Ciphertext, rlk: KeySwitchKey) -> Ciphertext:
        d2_coeff = poly_intt(ct.c[2], self.ctx)
        k0, k1 = keyswitch(d2_coeff.data, rlk, ct.level, self.ctx, self.L,
                           t=self.ks_t, dnum=self.dnum)
        c0 = poly_add(ct.c[0], RnsPoly(k0, True), self.ctx)
        c1 = poly_add(ct.c[1], RnsPoly(k1, True), self.ctx)
        return Ciphertext([c0, c1], 1.0, ct.correction)

    def relinearize(self, ct: Ciphertext) -> Ciphertext:
        assert ct.size == 3
        return self._jit("relinearize", self._relinearize_impl)(ct, self.rlk)

    def multiply_relin(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self.relinearize(self.multiply(a, b))

    def _apply_galois_impl(self, ct: Ciphertext, ksk: KeySwitchKey, g: int) -> Ciphertext:
        c0g = poly_automorphism(ct.c[0], g, self.ctx)
        c1g = poly_automorphism(ct.c[1], g, self.ctx)
        k0, k1 = keyswitch(poly_intt(c1g, self.ctx).data, ksk, ct.level, self.ctx, self.L,
                           t=self.ks_t, dnum=self.dnum)
        c0 = poly_add(c0g, RnsPoly(k0, True), self.ctx)
        return Ciphertext([c0, RnsPoly(k1, True)], 1.0, ct.correction)

    def apply_galois(self, ct: Ciphertext, g: int) -> Ciphertext:
        """σ_g then keyswitch σ_g(s) -> s."""
        assert ct.size == 2
        ksk = self.galois_key(g)
        return self._jit(("galois", g),
                         lambda c, k: self._apply_galois_impl(c, k, g))(ct, ksk)

    def rotation_galois_element(self, r: int) -> int:
        n = self.params.n
        return pow(5, r % (n // 2), 2 * n)

    def rotate_rows(self, ct: Ciphertext, r: int) -> Ciphertext:
        """Cycle both rows of the slot matrix left by r."""
        return self.apply_galois(ct, self.rotation_galois_element(r))

    def rotate_columns(self, ct: Ciphertext) -> Ciphertext:
        """Swap the two rows of the slot matrix."""
        return self.apply_galois(ct, 2 * self.params.n - 1)


class BgvContext(BatchedContext):
    """BGV (`rfhe_tpu.fhe.bgv.BgvContext`): the noise of keys and
    encryptions is a multiple of t, and every mod-down keeps the message mod
    t; a modulus switch scales it by q_k⁻¹ mod t, which the ciphertext's
    `correction` carries to decryption."""

    def __init__(self, params, special_bits: Optional[int] = None, seed: int = 11,
                 dnum: Optional[int] = None, *, device):
        self.noise_factor = self.ks_t = params.t
        super().__init__(params, special_bits, seed, dnum, device)
        self._crt64_plans: Dict[int, Crt64Plan] = {}

    def encode(self, matrix: np.ndarray) -> RnsPoly:
        """(2, n/2) ints mod t -> coefficient-domain plaintext over the whole
        chain: the coefficients mod t, each lifted to every q_i."""
        coeffs = self._slots_to_coeffs(matrix)
        return RnsPoly(coeffs[None, :] % self.ctx.plan.slice(self.L).qb(1), False)

    def encrypt(self, pt: RnsPoly) -> Ciphertext:
        """Public-key encryption with t·e noise."""
        lvl = pt.level
        draws = draw_public(self.ctx, self.rng, lvl, self.params.sigma, self.t)
        c0, c1 = self._jit(("encrypt", lvl), lambda m, u, e0, e1, pk: encrypt_with(
            self.ctx, m, u, e0, e1, pk))(pt.data, *draws, self.pk)
        return Ciphertext([RnsPoly(c0, True), RnsPoly(c1, True)], 1.0)

    def decrypt_coeffs_t(self, ct: Ciphertext, exact: bool = False) -> np.ndarray:
        """[c(s)]_Q mod t times the correction, (n,) uint32.  The default
        reconstructs the small centered coefficient m + t·e on the device
        (`ops/crt64.py`, exact below 2^62); exact=True uses the host's
        object-int CRT."""
        lvl = ct.level
        corr = ct.correction % self.t
        if exact:
            signed = rns_to_signed(to_numpy_u32(self._decrypt_coeffs(ct)),
                                   self.params.moduli[:lvl + 1])
            return ((signed * corr) % self.t).astype(np.uint32)
        if lvl not in self._crt64_plans:
            self._crt64_plans[lvl] = Crt64Plan.make(self.params.moduli[:lvl + 1], self.device)
        cplan = self._crt64_plans[lvl]
        hi, lo = self._jit(("decrypt64", ct.size, lvl), lambda cs, sk: crt_to_words(
            self._decrypt_impl(cs, sk), cplan))([c.data for c in ct.c], self.sk)
        signed = words_to_signed(hi.cpu().numpy(), lo.cpu().numpy())
        return ((np.mod(signed, self.t) * corr) % self.t).astype(np.uint32)

    def _multiply_impl(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        mul = lambda x, y: poly_mul_pointwise(x, y, self.ctx)
        d1 = poly_add(mul(a.c[0], b.c[1]), mul(a.c[1], b.c[0]), self.ctx)
        return Ciphertext([mul(a.c[0], b.c[0]), d1, mul(a.c[1], b.c[1])], 1.0,
                          a.correction * b.correction % self.t)

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """Tensor product (a0, a1)×(b0, b1) -> (d0, d1, d2); corrections multiply."""
        assert a.size == 2 and b.size == 2 and a.level == b.level
        return self._jit("multiply", self._multiply_impl)(a, b)

    def multiply_relin(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        assert a.size == 2 and b.size == 2 and a.level == b.level
        return self._jit(
            "multiply_relin",
            lambda x, y, k: self._relinearize_impl(self._multiply_impl(x, y), k))(a, b, self.rlk)

    def multiply_plain(self, ct: Ciphertext, pt: RnsPoly) -> Ciphertext:
        pt_ntt = pt if pt.is_ntt else poly_ntt(RnsPoly(pt.data[:ct.level + 1], False), self.ctx)
        return Ciphertext([poly_mul_pointwise(c, pt_ntt, self.ctx) for c in ct.c], 1.0,
                          ct.correction)

    def mod_switch_to_next(self, ct: Ciphertext) -> Ciphertext:
        return self._jit("mod_switch", self._mod_switch_impl)(ct)

    def _mod_switch_impl(self, ct: Ciphertext) -> Ciphertext:
        """Divide by the top prime q_k keeping the message mod t: c' = (c −
        δ)/q_k with δ ≡ c (mod q_k), δ ≡ 0 (mod t), δ centered: the t-mode of
        `drop_limb`, every component in one batched call (the reference's
        `_mod_switch_impl` loops over them; the transforms are per vector).
        The message is scaled by q_k⁻¹ mod t, so the correction takes q_k."""
        k = ct.level
        out = drop_limb(torch.stack([p.data for p in ct.c]), k, k, self.ctx, self.t)
        return Ciphertext([RnsPoly(o, True) for o in out], 1.0,
                          ct.correction * self.params.moduli[k] % self.t)
