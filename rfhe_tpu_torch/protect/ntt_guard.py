"""End-to-end ABFT projection guard for the NTT plan.

Counterpart of `rfhe_tpu/protect/ntt_guard.py`.  The negacyclic NTT is
linear per limb: y = M x over Z_q with M[p, t] = R·ψ^t·ω^(nu[p]·t) (slot
order nu, Montgomery factor R = 2^32 mod q included, so the check works on
the stored values).  With a random projection φ per limb and v = Mᵀφ built
once per plan, every transform is verified by two length-n modular dots,

    <φ, y>  ==  <v, x>   (mod q),

which miss a fault that changes the output with probability about 1/q.
Mᵀφ is computed by the plan itself, one transform per direction at build
(the reference's construction, `ntt_guard.py:24-30`): for h[k] = φ[nu_inv[k]],
(Mᵀφ)[t] = R·ψ^t·Ĥ[t] with Ĥ = fwd(h ⊙ ψ^-t ⊙ R^-1)[nu_inv], and the inverse
direction uses Ĝ[k] = Ĝ⁺[(n-k) mod n].  The tables are built for all limbs
at once in numpy (power rows by doubling), the same values as the
reference's per-limb loops; φ is drawn from the same numpy seed.  Beside the
reference's Montgomery tables the guard keeps them with R^-1 applied (φ, Mᵀφ,
M⁻ᵀφ), so a runtime dot is one product, one sum and two reductions; the dots'
values are the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

from ..numth import mod_inv, psi_negacyclic
from ..ops.modarith import mont_mul
from ..ops.modring import sum_mod

__all__ = ["NttGuard"]


def _pow_rows(bases: np.ndarray, q: np.ndarray, n: int) -> np.ndarray:
    """base_l^i mod q_l for i < n (a power of two), one row per limb: the upper
    half of each prefix is the lower half times base^len (products < 2^62)."""
    out = np.ones((len(bases), n), dtype=np.uint64)
    m = 1
    while m < n:
        step = np.array([pow(int(b), m, int(p)) for b, p in zip(bases, q[:, 0])], dtype=np.uint64)
        out[:, m:2 * m] = out[:, :m] * step[:, None] % q
        m *= 2
    return out


@dataclass(frozen=True)
class NttGuard:
    """Projection tables for one NTT plan (all limbs, stacked), int64 on the
    plan's device."""

    phi_mont: torch.Tensor     # (L, n) φ·R mod q
    vf_mont: torch.Tensor      # (L, n) (Mᵀφ)·R mod q     (forward)
    vi_mont: torch.Tensor      # (L, n) (M⁻ᵀφ)·R mod q    (inverse)
    q_arr: torch.Tensor        # (L,)
    rinv_arr: torch.Tensor     # (L,) R^-1 mod q
    psi_inv: torch.Tensor      # (L, n) ψ^-t               (transpose_probe)
    dmont: torch.Tensor        # (L, n) ψ^t·R² mod q
    phi: torch.Tensor          # (L, n) φ                   (the runtime checks)
    vf: torch.Tensor           # (L, n) Mᵀφ
    vi: torch.Tensor           # (L, n) M⁻ᵀφ
    _views: Dict[Tuple[int, ...], "NttGuard"] = field(default_factory=dict, compare=False,
                                                      repr=False)

    @classmethod
    def make(cls, plan, seed: int = 2024) -> "NttGuard":
        n, qs = plan.n, plan.primes
        rng = np.random.default_rng(seed)
        nu, nu_inv = plan.nu, plan.nu_inv
        phi = np.stack([rng.integers(1, q, n, dtype=np.uint64) for q in qs])
        q = np.array(qs, dtype=np.uint64)[:, None]
        R = np.array([(1 << 32) % p for p in qs], dtype=np.uint64)[:, None]
        col = lambda vals: np.array(vals, dtype=np.uint64)[:, None]
        psis = [psi_negacyclic(n, p) for p in qs]
        pw = _pow_rows(np.array(psis), q, n)
        pi = _pow_rows(np.array([mod_inv(p, qq) for p, qq in zip(psis, qs)]), q, n)
        rinv = col([mod_inv((1 << 32) % p, p) for p in qs])
        zf = (phi[:, nu_inv] * pi % q) * rinv % q
        # the inverse probe g = φ ⊙ ψ^-t, fed through the ψ-untwist too
        zg = (phi * pi % q * pi % q) * rinv % q
        dev = plan.device
        fwd = lambda z: plan.fwd(torch.from_numpy(z.astype(np.int64)).to(dev)).cpu().numpy()
        Hf = fwd(zf).astype(np.uint64)[:, nu_inv]
        Gp = fwd(zg).astype(np.uint64)[:, nu_inv]
        vf = (Hf * pw % q) * R % q
        c = col([mod_inv(n, p) * mod_inv((1 << 32) % p, p) % p for p in qs])
        vi = Gp[:, (n - nu) % n] * c % q
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int64)).to(dev)
        return cls(phi_mont=t(phi * R % q), vf_mont=t(vf * R % q), vi_mont=t(vi * R % q),
                   q_arr=plan.q_arr, rinv_arr=plan.rinv_arr,
                   psi_inv=t(pi), dmont=t(pw * R % q * R % q), phi=t(phi), vf=t(vf), vi=t(vi))

    @property
    def L(self) -> int:
        return int(self.q_arr.shape[0])

    def take(self, idx) -> "NttGuard":
        """The tables of the limbs at positions `idx` (kept per index list)."""
        key = tuple(int(i) for i in idx)
        view = self._views.get(key)
        if view is None:
            sel = torch.tensor(key, dtype=torch.int64, device=self.q_arr.device)
            view = self._views[key] = NttGuard(**{
                f: getattr(self, f).index_select(0, sel)
                for f in self.__dataclass_fields__ if f != "_views"})
        return view

    def slice(self, k: int) -> "NttGuard":
        return self.take(np.arange(k))

    # -- probe construction ------------------------------------------------
    def transpose_probe(self, plan, probe_mont: torch.Tensor) -> torch.Tensor:
        """Mᵀu for an arbitrary probe u in Montgomery form ((..., L, n)
        stored values): V with Σ mont_mul(V, x) == Σ mont_mul(u, plan.fwd(x))
        (mod q) per limb for every x, so a check of a whole linear pipeline
        (NTT, ⊙key, sum) reads only its input.  z = u[nu_inv]·ψ^-t,
        Û = fwd(z)[nu_inv], V = Û·ψ^t·R²·R^-1 (`ntt_guard.py:136-152`)."""
        qb, rinvb = self.q_arr[:, None], self.rinv_arr[:, None]
        nu_inv = plan.tables.nu_inv_t
        z = mont_mul(probe_mont.index_select(-1, nu_inv), self.psi_inv, qb, rinvb)
        u_hat = plan.fwd(z).index_select(-1, nu_inv)
        return mont_mul(u_hat, self.dmont, qb, rinvb)

    # -- runtime checks ----------------------------------------------------
    def _dot(self, w_mont: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """<w, x> mod q per limb for w in Montgomery form (the reference's
        `_dot`): (..., L, n) -> (..., L); x any words below 2^32."""
        prod = mont_mul(w_mont, x, self.q_arr[:, None], self.rinv_arr[:, None])
        return sum_mod(prod, self.q_arr, axis=-1)

    def dot(self, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """<w, x> mod q per limb for w in the normal domain: `_dot` of w·R."""
        return sum_mod(w * x % self.q_arr[:, None], self.q_arr, axis=-1)

    def check_fwd(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """ok per limb for y = plan.fwd(x): (..., L) bool."""
        return self.dot(self.phi, y) == self.dot(self.vf, x)

    def check_inv(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """ok per limb for x = plan.inv(y)."""
        return self.dot(self.phi, x) == self.dot(self.vi, y)
