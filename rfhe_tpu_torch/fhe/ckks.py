"""CKKS scheme layer: encode/decode, encrypt/decrypt, evaluator.

Counterpart of `rfhe_tpu/fhe/ckks.py`.  Encode/decode run on the host in
float64 (copies of the reference's numpy functions); everything after
encode is exact integer RNS arithmetic on the context's device.  As in the
reference, encrypt, decrypt and every public evaluator op run their
implementations (`_*_impl`) through one cached program per (op, signature)
(`_jit`, with the reference's keys): on a card a CUDA graph captured once
and replayed (`utils/jitcache.py`), on the CPU the implementation itself.
The host's draws (u, e0, e1, the seeded a) are made outside the program and
passed in; the keys are read where they lie.  With the same parameters and
seed the keys and every ciphertext array equal the reference's
(tests/test_torch_ckks.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import to_numpy_u32, to_torch
from ..numth import crt_constants
from ..ops.crt64 import Crt64Plan, crt_to_words, words_to_signed
from ..ops.modarith import add_mod, mont_mul, sub_mod
from ..trace import spans
from ..utils.jitcache import GraphPool, HoistedJit, hoisted_jit
from .keys import (
    KeyGen, KeySwitchKey, PublicKey, SecretKey, _digit_groups,
    _rns_from_signed, _sample_gaussian, _sample_ternary, keyswitch,
)
from .params import CkksParams, make_prime_chain
from .rns import (
    RnsContext, RnsPoly, poly_add, poly_automorphism, poly_intt,
    poly_mul_pointwise, poly_ntt, poly_sub, rescale,
)


# ---------------------------------------------------------------------------
# host-side canonical embedding (copies of the reference's numpy functions)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=8)
def _slot_exponents(n: int) -> np.ndarray:
    """k_j = 5^j mod 2n for j < n/2 (`ckks._slot_exponents`)."""
    ks = np.empty(n // 2, dtype=np.int64)
    k = 1
    for j in range(n // 2):
        ks[j] = k
        k = (k * 5) % (2 * n)
    return ks


def encode(z: np.ndarray, n: int, scale: float, moduli) -> np.ndarray:
    """Complex slots (n/2,) -> (L, N) uint32 RNS coefficients (`ckks.encode`)."""
    z = np.asarray(z, dtype=np.complex128)
    assert z.shape == (n // 2,)
    ks = _slot_exponents(n)
    g = np.zeros(n, dtype=np.complex128)
    g[(ks - 1) // 2] = z
    g[(2 * n - ks - 1) // 2] = np.conj(z)
    t = np.arange(n)
    twist = np.exp(-1j * np.pi * t / n)
    a = np.real(twist * np.fft.fft(g)) / n * scale
    coeffs = np.round(a).astype(np.int64)
    return np.stack([np.mod(coeffs, q).astype(np.uint32) for q in moduli])


def decode(coeffs_signed: np.ndarray, n: int, scale: float) -> np.ndarray:
    """Signed integer coefficients (N,) -> complex slots (n/2,) (`ckks.decode`)."""
    ks = _slot_exponents(n)
    a = coeffs_signed.astype(np.float64)
    t = np.arange(n)
    twist = np.exp(1j * np.pi * t / n)
    F = n * np.fft.ifft(a * twist)
    return F[(ks - 1) // 2] / scale


def rns_to_signed(data: np.ndarray, moduli) -> np.ndarray:
    """CRT-reconstruct (L, N) residues to centered Python-int coefficients
    (`ckks.rns_to_signed`)."""
    moduli = [int(q) for q in moduli]
    P, hat_p, inv_hat_p = crt_constants(moduli)
    weights = [(hat_p[j] * inv_hat_p[j]) % P for j in range(len(moduli))]
    acc = np.zeros(data.shape[1], dtype=object)
    for j in range(len(moduli)):
        acc += data[j].astype(object) * weights[j]
    acc %= P
    return np.where(acc > P // 2, acc - P, acc)


# ---------------------------------------------------------------------------
# context & ciphertext
# ---------------------------------------------------------------------------

def draw_public(ctx: RnsContext, rng: np.random.Generator, level: int, sigma: float,
                noise_factor: int = 1) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(u, e0, e1) of a public-key encryption at `level`, drawn from `rng` in
    the reference's order, each gaussian scaled by `noise_factor` (t in BGV),
    as residues on the context's device."""
    n = ctx.n
    moduli = ctx.moduli[:level + 1]
    u = _rns_from_signed(_sample_ternary(rng, n), moduli)
    e0, e1 = (_rns_from_signed(noise_factor * _sample_gaussian(rng, n, sigma), moduli)
              for _ in range(2))
    return tuple(to_torch(v, ctx.device) for v in (u, e0, e1))


def encrypt_with(ctx: RnsContext, m: torch.Tensor, u: torch.Tensor, e0: torch.Tensor,
                 e1: torch.Tensor, pk: PublicKey) -> Tuple[torch.Tensor, torch.Tensor]:
    """(c0, c1) = (pk.b·u + NTT(e0 + m), pk.a·u + NTT(e1)) at the level of
    the coefficient-domain m (level+1, N): the encryption of every scheme's
    context, given its draws (`draw_public`)."""
    lvl = m.shape[0] - 1
    plan = ctx.plan_at(lvl)
    q, rinv = plan.qb(1), plan.rinvb(1)
    u_ntt, m0_ntt, m1_ntt = plan.fwd(torch.stack((u, add_mod(e0, m, q), e1)))
    c0 = add_mod(mont_mul(pk.b[:lvl + 1], u_ntt, q, rinv), m0_ntt, q)
    c1 = add_mod(mont_mul(pk.a[:lvl + 1], u_ntt, q, rinv), m1_ntt, q)
    return c0, c1


def dot_secret(ctx: RnsContext, s_ntt: torch.Tensor, comps: Sequence[torch.Tensor]
               ) -> torch.Tensor:
    """c0 + c1·s (+ c2·s²), NTT domain, at the level of the components."""
    lvl = comps[0].shape[0] - 1
    plan = ctx.plan_at(lvl)
    q, rinv = plan.qb(1), plan.rinvb(1)
    s = s_ntt[:lvl + 1]
    acc = comps[0]
    spow = s
    for comp in comps[1:]:
        acc = add_mod(acc, mont_mul(comp, spow, q, rinv), q)
        spow = mont_mul(spow, s, q, rinv)
    return acc


@dataclass
class Ciphertext:
    c: List[RnsPoly]          # 2 (or 3 before relinearization), NTT domain
    scale: float
    # BGV only: the factor decryption multiplies by (mod t); a modulus
    # switch by q_k scales the message by q_k^{-1} mod t
    correction: int = 1

    def tree_flatten(self):
        # scale and correction are static metadata of the op sequence
        return (self.c,), (self.scale, self.correction)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(c=list(children[0]), scale=aux[0], correction=aux[1])

    @property
    def level(self) -> int:
        return self.c[0].level

    @property
    def size(self) -> int:
        return len(self.c)

    @classmethod
    def from_numpy(cls, comps: Sequence[np.ndarray], scale: float,
                   is_ntt: bool, device) -> "Ciphertext":
        """Components as uint32 arrays (level+1, N), e.g. the `.data` of a
        reference ciphertext, onto `device`."""
        return cls([RnsPoly(to_torch(c, device), is_ntt) for c in comps], scale)

    def to_numpy(self) -> List[np.ndarray]:
        return [to_numpy_u32(p.data) for p in self.c]


class CkksContext:
    """Parameters, RNS tables (ciphertext primes + special primes) and key
    material on one device.  `device` is required: nothing picks one.
    `dnum` groups the keyswitch digits: α = ⌈L/dnum⌉ limbs per digit and α
    special primes; None is per-limb digits with one special prime."""

    def __init__(self, params: CkksParams, special_bits: Optional[int] = None,
                 seed: int = 7, dnum: Optional[int] = None, *, device):
        if dnum is not None and dnum < 1:
            raise ValueError(f"dnum must be a positive integer or None, got {dnum}")
        self.params = params
        self.device = torch.device(device)
        n = params.n
        if special_bits is None:
            special_bits = 30 if n >= 65536 else 31
        self.dnum = dnum
        n_sp = 1 if dnum is None else -(-params.L // dnum)
        # special primes: NTT primes not colliding with the chain
        sps = [p for p in make_prime_chain(n, [special_bits] * (n_sp + 2))
               if p not in params.moduli][:n_sp]
        if len(sps) != n_sp:
            raise ValueError(f"not enough {special_bits}-bit special primes for dnum={dnum}")
        self.special = sps[0]
        self.specials = tuple(sps)
        self.ctx = RnsContext.make(n, tuple(params.moduli) + self.specials, self.device)
        self.L = params.L
        self.keygen = KeyGen(self.ctx, self.L, params.sigma)
        self.rng = np.random.default_rng(seed)
        self.sk = self.keygen.gen_secret(self.rng)
        self.pk = self.keygen.gen_public(self.sk, self.rng)
        self._rlk: Optional[KeySwitchKey] = None
        self._galois: Dict[int, KeySwitchKey] = {}
        self._crt64_plans: Dict[int, Crt64Plan] = {}
        self._jits: Dict = {}
        self._graphs = GraphPool()

    # -- keys ---------------------------------------------------------------
    @property
    def rlk(self) -> KeySwitchKey:
        """Relinearization key, drawn from the context's rng on first use."""
        if self._rlk is None:
            q, rinv = self.ctx.plan.qb(1), self.ctx.plan.rinvb(1)
            s2 = mont_mul(self.sk.s_ntt, self.sk.s_ntt, q, rinv)
            self._rlk = self.keygen.gen_keyswitch(self.sk, s2, self.rng, dnum=self.dnum)
        return self._rlk

    def galois_key(self, g: int) -> KeySwitchKey:
        """Galois key for X -> X^g, drawn from the context's rng on first use."""
        if g not in self._galois:
            s_g = self.sk.s_ntt.index_select(-1, self.ctx.galois_perm_t(g))
            self._galois[g] = self.keygen.gen_keyswitch(self.sk, s_g, self.rng,
                                                         dnum=self.dnum)
        return self._galois[g]

    def export_keys(self) -> Dict[str, np.ndarray]:
        """Key material as numpy arrays, named as `load_keys` takes them."""
        state = {"sk_s_ntt": to_numpy_u32(self.sk.s_ntt),
                 "sk_s_coeff": np.asarray(self.sk.s_coeff, dtype=np.int64),
                 "pk_b": to_numpy_u32(self.pk.b), "pk_a": to_numpy_u32(self.pk.a)}
        for g, k in self._galois.items():
            state[f"galois_{g}_b"] = to_numpy_u32(k.b)
            state[f"galois_{g}_a"] = to_numpy_u32(k.a)
        if self._rlk is not None:
            state["rlk_b"] = to_numpy_u32(self._rlk.b)
            state["rlk_a"] = to_numpy_u32(self._rlk.a)
        return state

    def load_keys(self, state: Dict[str, np.ndarray]) -> None:
        """Replace the key material with `state`: uint32 arrays `sk_s_ntt`,
        `pk_b`, `pk_a`, optional `galois_<g>_b/_a` and `rlk_b/_a`, and the
        ternary `sk_s_coeff`, laid out as the reference's key objects hold
        them (`rfhe_tpu/fhe/keys.py:36-60`).  Keyswitch keys have shape
        (n_groups, L + n_special, N) for this context's dnum; another shape
        raises.  The cached programs read the old keys, so they are dropped."""
        dev = self.device
        groups = _digit_groups(self.L, self.L if self.dnum is None else self.dnum)
        want = (len(groups), self.ctx.L, self.params.n)

        def ksk(stem: str) -> KeySwitchKey:
            b, a = state[f"{stem}_b"], state[f"{stem}_a"]
            if tuple(b.shape) != want or tuple(a.shape) != want:
                raise ValueError(f"{stem}: key shape {tuple(b.shape)} / {tuple(a.shape)}, "
                                 f"this context (dnum={self.dnum}) takes {want}")
            return KeySwitchKey(b=to_torch(b, dev), a=to_torch(a, dev))

        galois = {}
        for name in state:
            if name.startswith("galois_") and name.endswith("_b"):
                g = int(name[len("galois_"):-2])
                galois[g] = ksk(f"galois_{g}")
        rlk = ksk("rlk") if "rlk_b" in state else None
        self.sk = SecretKey(s_ntt=to_torch(state["sk_s_ntt"], dev),
                            s_coeff=np.asarray(state["sk_s_coeff"], dtype=np.int64))
        self.pk = PublicKey(b=to_torch(state["pk_b"], dev), a=to_torch(state["pk_a"], dev))
        self._galois, self._rlk = galois, rlk
        self._jits, self._graphs = {}, GraphPool()

    def rotation_galois_element(self, r: int) -> int:
        n = self.params.n
        return pow(5, r % (n // 2), 2 * n)

    # -- encode / encrypt ---------------------------------------------------
    def encode(self, z, scale: Optional[float] = None,
               level: Optional[int] = None) -> Tuple[RnsPoly, float]:
        scale = scale or self.params.scale
        level = self.L - 1 if level is None else level
        data = encode(np.asarray(z), self.params.n, scale,
                      self.params.moduli[:level + 1])
        return RnsPoly(to_torch(data, self.device), False), scale

    def encrypt(self, pt: RnsPoly, scale: float) -> Ciphertext:
        """Public-key encryption; draws u, e0, e1 from the context's rng in
        the reference's order."""
        lvl = pt.level
        u, e0, e1 = draw_public(self.ctx, self.rng, lvl, self.params.sigma)
        c0, c1 = self._jit(("encrypt", lvl), lambda m, u, e0, e1, pk: encrypt_with(
            self.ctx, m, u, e0, e1, pk))(pt.data, u, e0, e1, self.pk)
        return Ciphertext([RnsPoly(c0, True), RnsPoly(c1, True)], scale)

    def encrypt_seeded(self, pt: RnsPoly, scale: float, seed: int) -> Ciphertext:
        """Symmetric-key encryption whose c1 is expanded from `seed` by the
        SHAKE-256 stream of the seeded wire form (`serialize.sample_uniform_a`):
        c1 = a (uniform, NTT domain), c0 = NTT(m + e) − a·s, so the plain
        decryption recovers m + e.  Draws e from the context's rng
        (`rfhe_tpu.fhe.ckks.CkksContext.encrypt_seeded`)."""
        from .serialize import sample_uniform_a
        lvl = pt.level
        moduli = self.params.moduli[:lvl + 1]
        a = to_torch(sample_uniform_a(seed, (lvl + 1, self.params.n), moduli), self.device)
        e = to_torch(_rns_from_signed(_sample_gaussian(self.rng, self.params.n,
                                                       self.params.sigma), moduli), self.device)
        plan = self.ctx.plan_at(lvl)

        def enc(m, a, e, sk):
            q, rinv = plan.qb(1), plan.rinvb(1)
            m_ntt = plan.fwd(add_mod(e, m, q))
            return sub_mod(m_ntt, mont_mul(a, sk.s_ntt[:lvl + 1], q, rinv), q)

        c0 = self._jit(("encrypt_seeded", lvl), enc)(pt.data, a, e, self.sk)
        return Ciphertext([RnsPoly(c0, True), RnsPoly(a, True)], scale)

    def _decrypt_impl(self, comps: List[torch.Tensor], sk: SecretKey) -> torch.Tensor:
        """[c(s)]_Q, coefficient domain, at the level of the components."""
        plan = self.ctx.plan_at(comps[0].shape[0] - 1)
        return plan.inv(dot_secret(self.ctx, sk.s_ntt, comps))

    def decrypt(self, ct: Ciphertext) -> RnsPoly:
        out = self._jit(("decrypt", ct.size, ct.level), self._decrypt_impl)(
            [c.data for c in ct.c], self.sk)
        return RnsPoly(out, False)

    def _crt64_plan(self, lvl: int) -> Crt64Plan:
        if lvl not in self._crt64_plans:
            self._crt64_plans[lvl] = Crt64Plan.make(self.params.moduli[:lvl + 1], self.device)
        return self._crt64_plans[lvl]

    def decrypt_words(self, ct: Ciphertext) -> Tuple[torch.Tensor, torch.Tensor]:
        """Decrypt and CRT-reconstruct on the device: the plaintext
        coefficients as (hi, lo) 32-bit words of their 64-bit value."""
        cplan = self._crt64_plan(ct.level)
        return self._jit(("decrypt64", ct.size, ct.level), lambda cs, sk: crt_to_words(
            self._decrypt_impl(cs, sk), cplan))([c.data for c in ct.c], self.sk)

    def decrypt_decode(self, ct: Ciphertext, exact: bool = False) -> np.ndarray:
        """Decrypt + decode.  The default reconstructs the small centered
        coefficients on the device (exact for |coeff| < 2^62); exact=True
        uses the host object-int CRT."""
        if exact:
            signed = rns_to_signed(to_numpy_u32(self.decrypt(ct).data),
                                   self.params.moduli[:ct.level + 1])
        else:
            hi, lo = self.decrypt_words(ct)
            signed = words_to_signed(hi.cpu().numpy(), lo.cpu().numpy())
        return decode(signed.astype(np.float64), self.params.n, ct.scale)

    # -- evaluator: the implementations ------------------------------------
    def _add_impl(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return Ciphertext([poly_add(x, y, self.ctx) for x, y in zip(a.c, b.c)], a.scale)

    def _sub_impl(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return Ciphertext([poly_sub(x, y, self.ctx) for x, y in zip(a.c, b.c)], a.scale)

    def _multiply_impl(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        mul = lambda x, y: poly_mul_pointwise(x, y, self.ctx)
        d0 = mul(a.c[0], b.c[0])
        d1 = poly_add(mul(a.c[0], b.c[1]), mul(a.c[1], b.c[0]), self.ctx)
        d2 = mul(a.c[1], b.c[1])
        return Ciphertext([d0, d1, d2], a.scale * b.scale)

    def _relinearize_impl(self, ct: Ciphertext, rlk: KeySwitchKey) -> Ciphertext:
        d2_coeff = poly_intt(ct.c[2], self.ctx)
        k0, k1 = keyswitch(d2_coeff.data, rlk, ct.level, self.ctx, self.L, dnum=self.dnum)
        c0 = poly_add(ct.c[0], RnsPoly(k0, True), self.ctx)
        c1 = poly_add(ct.c[1], RnsPoly(k1, True), self.ctx)
        return Ciphertext([c0, c1], ct.scale)

    def _rescale_impl(self, ct: Ciphertext) -> Ciphertext:
        """Drop alpha top limbs (alpha=2 for a composite scale)."""
        cs, scale = ct.c, ct.scale
        for _ in range(self.params.alpha):
            q_top = self.params.moduli[cs[0].level]
            cs = [rescale(p, self.ctx) for p in cs]
            scale /= q_top
        return Ciphertext(cs, scale)

    def _multiply_plain_impl(self, ct: Ciphertext, pt: RnsPoly,
                             pt_scale: float) -> Ciphertext:
        pt_ntt = pt if pt.is_ntt else poly_ntt(pt, self.ctx)
        return Ciphertext([poly_mul_pointwise(c, pt_ntt, self.ctx) for c in ct.c],
                          ct.scale * pt_scale)

    def _apply_galois_impl(self, ct: Ciphertext, ksk: KeySwitchKey, g: int) -> Ciphertext:
        with spans.phases() as phase:                   # traced: trace/spans.py
            phase("PERMUTE")
            c0g = poly_automorphism(ct.c[0], g, self.ctx)
            c1g = poly_automorphism(ct.c[1], g, self.ctx)
            phase("INTT")
            c1_coeff = poly_intt(c1g, self.ctx)
        k0, k1 = keyswitch(c1_coeff.data, ksk, ct.level, self.ctx, self.L, dnum=self.dnum)
        c0 = poly_add(c0g, RnsPoly(k0, True), self.ctx)
        return Ciphertext([c0, RnsPoly(k1, True)], ct.scale)

    # -- evaluator: one cached program per (op, signature) ------------------
    def _jit(self, name, fn) -> HoistedJit:
        if name not in self._jits:
            self._jits[name] = hoisted_jit(fn, self._graphs, name)
        return self._jits[name]

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        assert abs(a.scale - b.scale) / a.scale < 1e-9 and a.level == b.level
        return self._jit("add", self._add_impl)(a, b)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        assert a.level == b.level
        return self._jit("sub", self._sub_impl)(a, b)

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """Tensor product: (a0,a1)x(b0,b1) -> (d0, d1, d2), scales multiply."""
        assert a.size == 2 and b.size == 2 and a.level == b.level
        return self._jit("multiply", self._multiply_impl)(a, b)

    def relinearize(self, ct: Ciphertext) -> Ciphertext:
        assert ct.size == 3
        return self._jit("relinearize", self._relinearize_impl)(ct, self.rlk)

    def multiply_relin(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        assert a.size == 2 and b.size == 2 and a.level == b.level
        return self._jit(
            "multiply_relin",
            lambda x, y, k: self._relinearize_impl(self._multiply_impl(x, y), k))(a, b, self.rlk)

    def rescale(self, ct: Ciphertext) -> Ciphertext:
        return self._jit("rescale", self._rescale_impl)(ct)

    def multiply_plain(self, ct: Ciphertext, pt: RnsPoly,
                       pt_scale: float) -> Ciphertext:
        out = self._jit("multiply_plain",
                        lambda c, p: self._multiply_plain_impl(c, p, 1.0))(ct, pt)
        return Ciphertext(out.c, ct.scale * pt_scale, out.correction)

    def apply_galois(self, ct: Ciphertext, g: int) -> Ciphertext:
        """σ_g then keyswitch σ_g(s) -> s."""
        assert ct.size == 2
        ksk = self.galois_key(g)
        return self._jit(("galois", g),
                         lambda c, k: self._apply_galois_impl(c, k, g))(ct, ksk)

    def rotate(self, ct: Ciphertext, r: int) -> Ciphertext:
        """Rotate slots by r positions."""
        return self.apply_galois(ct, self.rotation_galois_element(r))

    def conjugate(self, ct: Ciphertext) -> Ciphertext:
        return self.apply_galois(ct, 2 * self.params.n - 1)
