"""The one generator of the benchmark's traffic: homomorphic circuits.

A traffic mix is a JSON file, `benchmark/traffic/<mix>.json`, that names a
circuit `kind` below and its parameters.  The generator draws everything a
circuit reads from the run's seed on the device (messages, weights; the keys
come from `reference.scheme.Keys`), encrypts a pool of `pool` input sets at
set-up, and evaluates circuit i on set i mod `pool` through the program's
public evaluator, so that no result can be served from the call before.
Each kind also gives the plaintext answer of set i, computed by the
reference, and the numbers that judge an output against it.

A kind is registered with `@kind(name)`.  Those below live here; any other
lives in a file of its own, `benchmark/kinds/<kind>.py`, which `make` loads
from the checkout by path the first time a mix names it, so that a later
kind is a new file and no edit here.

Kinds here:
  bsgs_matvec   CKKS: y = M·x for a d×d matrix, baby-step giant-step over
                the d generalised diagonals, pre-rotated and encoded at
                set-up (`rfhe_tpu_torch/models/bsgs.py:matvec_bsgs`'s order)
  channel_mix   CKKS: y = Σ_c w_c ⊙ x_c over `channels` ciphertexts
  dot_product   BGV: `rfhe_tpu_torch/models/dotprod.py:dot_product_bgv`, or
                with `protected` its keyswitching ops through ProtectedBgv
                (flags read once per circuit; add and mod_switch plain)
"""
from __future__ import annotations

import importlib.util
import math
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import program
from .reference import scheme

KINDS: Dict[str, type] = {}
ROOT = Path(__file__).resolve().parent.parent


def kind(name: str):
    def register(cls):
        KINDS[name] = cls
        return cls
    return register


def kind_class(name: str, root: Path = ROOT) -> type:
    """The class registered as kind `name`: one of this file's, or the one
    that `benchmark/kinds/<name>.py` in the checkout at `root` registers."""
    if name not in KINDS:
        path = root / Path(__file__).parent.name / "kinds" / f"{name}.py"
        if not path.is_file():
            raise ValueError(f"unknown circuit kind {name!r}: no {path}; known: {sorted(KINDS)}")
        spec = importlib.util.spec_from_file_location(f"benchmark.kinds.{name}", path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        if name not in KINDS:
            raise ValueError(f"{path} registers no kind {name!r}")
    return KINDS[name]


def make(mix: dict, deployment: dict, control: Optional[dict], keys, gen, device,
         root: Path = ROOT):
    """The circuit a mix names, its kind found in the checkout at `root`."""
    cls = kind_class(mix["kind"], root)
    if cls.scheme != deployment["scheme"]:
        raise ValueError(f"{mix['kind']} is a {cls.scheme} circuit, the configuration is "
                         f"{deployment['scheme']}")
    return cls(mix, deployment, control, keys, gen, device)


class Circuit:
    scheme = ""
    relin = False

    def __init__(self, mix, deployment, control, keys, gen, device):
        self.mix, self.dep, self.control = mix, deployment, control
        self.keys, self.basis, self.gen, self.device = keys, keys.basis, gen, device
        self.n = deployment["n"]
        self.pool = mix["pool"]

    def rotation(self, r: int) -> int:
        """The Galois element of a rotation by r slots: 5^r mod 2n."""
        return pow(5, r % (self.n // 2), 2 * self.n)

    def galois(self) -> List[int]:
        return []

    def setup(self, ctx) -> None:
        raise NotImplementedError

    def run(self, i: int, fault=None):
        """Evaluate circuit i: (output ciphertext, flags tensor or None)."""
        raise NotImplementedError

    def judge(self, i: int, ct) -> Dict[str, float]:
        """The numbers compared for the output `ct` of circuit i."""
        raise NotImplementedError

    def release(self) -> None:
        """Drop what the program holds (context, ciphertexts, plaintexts),
        keeping the plaintext data the judgement reads."""
        for name in ("ctx", "pb", "inputs", "weights"):
            self.__dict__.pop(name, None)


class _Ckks(Circuit):
    scheme = "ckks"

    def __init__(self, *args):
        super().__init__(*args)
        bits = (self.control or {}).get("scale_bits", self.dep["scale_bits"])
        self.scale = float(2 ** bits)
        self.top = self.basis.L - 1

    def slots(self, shape) -> torch.Tensor:
        """Complex messages, real and imaginary parts uniform in [-1, 1)."""
        re, im = (2 * torch.rand(shape, generator=self.gen, device=self.device,
                                 dtype=torch.float64) - 1 for _ in range(2))
        return torch.complex(re, im)

    def encode_slots(self, z: torch.Tensor) -> torch.Tensor:
        """Messages (B, n/2) -> plaintext slots at the top level (B, L, n)."""
        tab = self.basis.level_tables(self.top)
        return tab.fwd(scheme.residues(scheme.ckks_encode(z, self.scale), tab))

    def encrypt(self, z: torch.Tensor) -> list:
        tab = self.basis.level_tables(self.top)
        c0, c1 = self.keys.encrypt(scheme.residues(scheme.ckks_encode(z, self.scale), tab),
                                   self.top)
        return program.ciphertexts(c0, c1, self.scale)

    def judge(self, i: int, ct) -> Dict[str, float]:
        v, mismatch = self.keys.decrypt(ct.c[0].data, ct.c[1].data)
        got = scheme.ckks_decode(v, self.scale * self.scale / self.basis.ct[self.top])
        return {"slot_err": float((got - self.answer(i)).abs().max()),
                "limb_mismatch": mismatch}


@kind("bsgs_matvec")
class BsgsMatvec(_Ckks):
    def __init__(self, *args):
        super().__init__(*args)
        self.d = self.mix["d"]
        self.B = math.isqrt(self.d - 1) + 1          # ⌈√d⌉
        self.G = -(-self.d // self.B)

    def galois(self) -> List[int]:
        steps = list(range(1, self.B)) + [g * self.B for g in range(1, self.G)]
        return [self.rotation(r) for r in steps]

    def setup(self, ctx) -> None:
        d, reps = self.d, self.n // 2 // self.d
        self.ctx = ctx
        self.M = 2 * torch.rand((d, d), generator=self.gen, device=self.device,
                                dtype=torch.float64) - 1
        self.x = self.slots((self.pool, d))
        self.inputs = self.encrypt(self.x.repeat(1, reps))
        rows = torch.arange(d, device=self.device)
        diags = torch.stack([self.M[rows, (rows + k) % d] for k in range(d)])
        # diagonal g·B + b, pre-rotated by -g·B on the plaintext side
        pre = torch.stack([torch.roll(diags[k], (k // self.B) * self.B) for k in range(d)])
        self.weights = program.plaintexts(self.encode_slots(pre.to(torch.complex128)
                                                            .repeat(1, reps)))

    def run(self, i: int, fault=None):
        ctx, x, B = self.ctx, self.inputs[i % self.pool], self.B
        baby = [x] + [ctx.rotate(x, b) for b in range(1, B)]
        acc = None
        for g in range(self.G):
            inner = None
            for b in range(B):
                k = g * B + b
                if k >= self.d:
                    break
                term = ctx.multiply_plain(baby[b], self.weights[k], self.scale)
                inner = term if inner is None else ctx.add(inner, term)
            if g:
                inner = ctx.rotate(inner, g * B)
            acc = inner if acc is None else ctx.add(acc, inner)
        return ctx.rescale(acc), None

    def answer(self, i: int) -> torch.Tensor:
        y = (self.M.to(torch.complex128) @ self.x[i % self.pool])
        return y.repeat(self.n // 2 // self.d)


@kind("channel_mix")
class ChannelMix(_Ckks):
    def setup(self, ctx) -> None:
        c, half = self.mix["channels"], self.n // 2
        self.ctx = ctx
        self.w = self.slots((c, half))
        self.weights = program.plaintexts(self.encode_slots(self.w))
        self.x = self.slots((self.pool, c, half))
        self.inputs = [self.encrypt(self.x[k]) for k in range(self.pool)]

    def run(self, i: int, fault=None):
        ctx, xs = self.ctx, self.inputs[i % self.pool]
        acc = None
        for x, w in zip(xs, self.weights):
            term = ctx.multiply_plain(x, w, self.scale)
            acc = term if acc is None else ctx.add(acc, term)
        return ctx.rescale(acc), None

    def answer(self, i: int) -> torch.Tensor:
        return (self.w * self.x[i % self.pool]).sum(dim=0)


@kind("dot_product")
class DotProduct(Circuit):
    scheme = "bgv"
    relin = True
    FAULT_STAGES = ("c1_perm", "intt_out", "digits", "digits_ntt", "prod0", "acc0")

    def galois(self) -> List[int]:
        steps = [1 << k for k in range((self.n // 2).bit_length() - 1)]
        return [self.rotation(r) for r in steps] + [2 * self.n - 1]

    def setup(self, ctx) -> None:
        from rfhe_tpu_torch.models.dotprod import dot_product_bgv
        self.ctx, self.dot = ctx, dot_product_bgv
        self.pb = program.protect(ctx) if self.mix["protected"] else None
        t, top = self.basis.t, self.basis.L - 1
        self.xy = torch.randint(0, t, (self.pool, 2, 2, self.n // 2), generator=self.gen,
                                device=self.device)
        coeffs = scheme.bgv_encode(self.xy.reshape(2 * self.pool, 2, self.n // 2), self.basis)
        c0, c1 = self.keys.encrypt(scheme.residues(coeffs, self.basis.level_tables(top)), top)
        cts = program.ciphertexts(c0, c1)
        self.inputs = [(cts[2 * k], cts[2 * k + 1]) for k in range(self.pool)]

    def run(self, i: int, fault=None):
        x, y = self.inputs[i % self.pool]
        if self.pb is None:
            return self.dot(self.ctx, x, y), None
        ctx, pb, flags = self.ctx, self.pb, []
        prod, f = pb.multiply_relin(x, y)
        flags.append(f)
        prod = ctx.mod_switch_to_next(prod)
        step = 1
        while step < self.n // 2:
            r, f = pb.rotate_rows(prod, step, fault if step == 1 else None)
            flags.append(f)
            prod = ctx.add(prod, r)
            step <<= 1
        r, f = pb.apply_galois(prod, 2 * self.n - 1)
        flags.append(f)
        ok = torch.stack([torch.all(v) for fl in flags for v in fl.values()]).all()
        return ctx.add(prod, r), ok

    def answer(self, i: int, dtype=torch.int64) -> torch.Tensor:
        """Σ x·y mod t in every slot; the control computes it in `dtype`."""
        x, y = self.xy[i % self.pool]
        total = (x.to(dtype) * y.to(dtype)).sum(dtype=dtype).to(torch.int64) % self.basis.t
        return total.expand(2, self.n // 2)

    def judge(self, i: int, ct) -> Dict[str, float]:
        low = (self.control or {}).get("dot_dtype")
        if low:                         # the reference, in the program's place, in low words
            got, mismatch = self.answer(i, getattr(torch, low)), 0
        else:
            t = self.basis.t
            corr = self.basis.ct[self.basis.L - 1] % t     # one modulus switch: m·q_top^-1
            v, mismatch = self.keys.decrypt(ct.c[0].data, ct.c[1].data)
            got = scheme.bgv_decode(v % t * corr % t, self.basis)
        return {"slot_mismatch": int((got != self.answer(i)).sum()), "limb_mismatch": mismatch}
