"""The system under test: rfhe_tpu_torch's evaluator, built from a configuration.

The benchmark makes the keys (benchmark/reference/scheme.py) and hands them
over through the program's public constructors and key slots: a
`CkksContext` takes them through `load_keys` (numpy uint32, the layout its
docstring gives); a `BgvContext` or `BfvContext` has no `load_keys`, so its
`sk`, `pk`, `rlk` and Galois keys are set as the objects its key generation
would make.  Each takes the configuration's keyswitch layout (`Basis.dnum`).
Ciphertexts and plaintexts built by the benchmark are wrapped in the
program's `Ciphertext` and `RnsPoly`.  `spans()` is the program's span
recorder, which the benchmark turns on in a traced run only.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from rfhe_tpu_torch.fhe.bfv import BfvContext
from rfhe_tpu_torch.fhe.bgv import BgvContext
from rfhe_tpu_torch.fhe.ckks import Ciphertext, CkksContext
from rfhe_tpu_torch.fhe.keys import KeySwitchKey, PublicKey, SecretKey
from rfhe_tpu_torch.fhe.params import BfvParams, BgvParams, CkksParams
from rfhe_tpu_torch.fhe.protected import Fault, ProtectedBgv
from rfhe_tpu_torch.fhe.rns import RnsPoly


def _u32(t: torch.Tensor) -> np.ndarray:
    """Residues below 2^31 as the uint32 numpy array `load_keys` takes."""
    return t.to(torch.int32).cpu().numpy().view(np.uint32)


def build(deployment: dict, keys, galois: Iterable[int], relin: bool, seed: int, device):
    """The program's context for `deployment`, holding the benchmark's keys:
    the secret and public key, a Galois key for each element of `galois`,
    and the relinearisation key if `relin`.  The scheme is one that
    `Basis.make` took: "ckks", else "bfv", else "bgv"."""
    basis, kind = keys.basis, deployment["scheme"]
    if kind == "ckks":
        params = CkksParams.make(n=deployment["n"], levels=deployment["levels"],
                                 q0_bits=deployment["q0_bits"],
                                 scale_bits=deployment["scale_bits"])
        ctx = CkksContext(params, special_bits=deployment["special_prime_bits"], seed=seed,
                          dnum=basis.dnum, device=device)
    else:
        params_cls, ctx_cls = (BfvParams, BfvContext) if kind == "bfv" else (BgvParams, BgvContext)
        params = params_cls.make(n=deployment["n"], levels=deployment["levels"],
                                 q_bits=deployment["q_bits"], t_bits=deployment["t_bits"])
        ctx = ctx_cls(params, special_bits=deployment["special_prime_bits"], seed=seed,
                      dnum=basis.dnum, device=device)
    if tuple(ctx.ctx.moduli) != basis.ct + basis.special or ctx.params.n != basis.n:
        raise ValueError(f"the program's basis {ctx.ctx.moduli} is not the configuration's "
                         f"{basis.ct + basis.special}")
    if kind == "ckks":
        state = {"sk_s_ntt": _u32(keys.s_slots), "sk_s_coeff": keys.s.cpu().numpy(),
                 "pk_b": _u32(keys.pk_b), "pk_a": _u32(keys.pk_a)}
        for g in galois:
            b, a = keys.galois_key(g)
            state[f"galois_{g}_b"], state[f"galois_{g}_a"] = _u32(b), _u32(a)
            del b, a
        if relin:
            b, a = keys.relin_key()
            state["rlk_b"], state["rlk_a"] = _u32(b), _u32(a)
            del b, a
        ctx.load_keys(state)
        return ctx
    if ctx.t != basis.t:
        raise ValueError(f"the program's t {ctx.t} is not the configuration's {basis.t}")
    ctx.sk = SecretKey(s_ntt=keys.s_slots.clone(), s_coeff=keys.s.cpu().numpy())
    ctx.pk = PublicKey(b=keys.pk_b.clone(), a=keys.pk_a.clone())
    ctx.rlk = KeySwitchKey(*keys.relin_key()) if relin else None
    ctx._galois = {g: KeySwitchKey(*keys.galois_key(g)) for g in galois}
    ctx._jits = {}
    return ctx


def spans():
    """The program's span recorder and counters (`rfhe_tpu_torch.trace.spans`),
    or None for a program that has none."""
    try:
        from rfhe_tpu_torch.trace import spans as recorder
    except ImportError:
        return None
    return recorder


def protect(ctx) -> ProtectedBgv:
    return ProtectedBgv(ctx)


def fault(stage: str, limb: int, idx: int, bit: int) -> Fault:
    """A one-bit flip into the keyswitch intermediate `stage`."""
    return Fault(stage, limb, idx, bit)


def ciphertexts(c0: torch.Tensor, c1: torch.Tensor, scale: float = 1.0) -> list:
    """A batch (B, level+1, n) of slot-domain pairs as the program's ciphertexts."""
    return [Ciphertext([RnsPoly(a.contiguous(), True), RnsPoly(b.contiguous(), True)], scale)
            for a, b in zip(c0, c1)]


def plaintexts(slots: torch.Tensor) -> list:
    """A batch (B, level+1, n) of slot-domain plaintexts as the program's polynomials."""
    return [RnsPoly(p.contiguous(), True) for p in slots]
