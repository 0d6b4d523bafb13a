"""Circuit kind `product_tree`, BFV: the slot-wise product of `inputs`
ciphertexts (a power of 2), multiplied pairwise level by level, every
product through `multiply_relin` (the BEHZ multiply, then the
relinearisation keyswitch), all at the top level: `inputs` − 1 products at
depth log2(`inputs`).

Set-up draws `pool` sets of `inputs` slot matrices uniformly mod t on the
device, encodes them (`bgv_encode`: BFV batches as BGV does) and encrypts
them by the reference as Δ·m.  An output is decrypted exactly by the
reference (`Keys.decrypt_bfv`) and judged by the slots that differ from the
product mod t, and by its noise against Δ/2.  The configuration's control
may name `prod_dtype`: the reference's product, in the program's place, in
those words.
"""
from __future__ import annotations

from typing import Dict

import torch

from benchmark import circuits, program
from benchmark.reference import scheme


@circuits.kind("product_tree")
class ProductTree(circuits.Circuit):
    scheme = "bfv"
    relin = True

    def __init__(self, *args):
        super().__init__(*args)
        self.inputs_per_set = self.mix["inputs"]
        if self.inputs_per_set < 2 or self.inputs_per_set & (self.inputs_per_set - 1):
            raise ValueError(f"inputs {self.inputs_per_set}: a power of 2, at least 2")

    def setup(self, ctx) -> None:
        k, top = self.inputs_per_set, self.basis.L - 1
        self.ctx = ctx
        self.x = torch.randint(0, self.basis.t, (self.pool, k, 2, self.n // 2),
                               generator=self.gen, device=self.device)
        coeffs = scheme.bgv_encode(self.x.reshape(self.pool * k, 2, self.n // 2), self.basis)
        c0, c1 = self.keys.encrypt(scheme.bfv_message(coeffs, self.basis, top), top)
        cts = program.ciphertexts(c0, c1)
        self.inputs = [cts[j * k:(j + 1) * k] for j in range(self.pool)]

    def run(self, i: int, fault=None):
        level = self.inputs[i % self.pool]
        while len(level) > 1:
            level = [self.ctx.multiply_relin(a, b) for a, b in zip(level[::2], level[1::2])]
        return level[0], None

    def answer(self, i: int, dtype=torch.int64) -> torch.Tensor:
        """The slot-wise product mod t, reduced after every product, in `dtype`."""
        x, t = self.x[i % self.pool].to(dtype), self.basis.t
        acc = x[0]
        for factor in x[1:]:
            acc = acc * factor % t
        return acc.to(torch.int64)

    def judge(self, i: int, ct) -> Dict[str, float]:
        m, noise_bits = self.keys.decrypt_bfv(ct.c[0].data, ct.c[1].data)
        low = (self.control or {}).get("prod_dtype")
        got = self.answer(i, getattr(torch, low)) if low else scheme.bgv_decode(m, self.basis)
        return {"slot_mismatch": int((got != self.answer(i)).sum()), "noise_bits": noise_bits}
