"""Motivation demos: a single fault in the transform or RNS domain smears
across every output slot, the observation behind ABFT protection.

Counterpart of `rfhe_tpu/models/motivation.py` (the reference's motivation/,
modulo_test/ and lattigo-error-demo/ experiments), returning its dicts:

  ntt_smear          one noisy coefficient before the NTT disturbs
                     (essentially) every output
  fft_smear          the complex-FFT analogue
  bsgs_block_smear   a block-diagonal matvec with one block's NTT domain
                     perturbed: the corruption stays in that block, whole
  baseconv_smear     a flipped RNS residue corrupts its element's converted
                     value in every output limb, and only that element
  grouped_crt_check  grouped-CRT reconstruction consistency
  plaintext_perturb  +1 on one NTT-domain plaintext coefficient before an
                     encrypted BGV plaintext multiply disturbs every slot; the
                     port's BgvContext on `device` (the hand NTT kernels on a
                     card)

Usage: python -m rfhe_tpu_torch.models.motivation [--device cuda]
"""
from __future__ import annotations

import argparse
import math
import random
from typing import Dict

import numpy as np

from .. import numth, oracle


def ntt_smear(n: int = 256, qbits: int = 20, noise_idx: int = 3, seed: int = 0) -> Dict:
    q = numth.find_ntt_prime(n, qbits)
    w = numth.root_of_unity(n, q)
    rng = random.Random(seed)
    a = [rng.randrange(q) for _ in range(n)]
    clean = oracle.ntt(a, w, q)
    a_noisy = list(a)
    a_noisy[noise_idx] = (a_noisy[noise_idx] + 1) % q
    noisy = oracle.ntt(a_noisy, w, q)
    disturbed = sum(1 for x, y in zip(clean, noisy) if x != y)
    return {"n": n, "disturbed": disturbed, "fraction": disturbed / n}


def fft_smear(n: int = 256, noise: float = 1e-3, seed: int = 0) -> Dict:
    a = np.random.default_rng(seed).normal(size=n)
    a2 = a.copy()
    a2[3] += noise
    disturbed = int((np.abs(np.fft.fft(a) - np.fft.fft(a2)) > 1e-12).sum())
    return {"n": n, "disturbed": disturbed, "fraction": disturbed / n}


def bsgs_block_smear(dim: int = 64, block: int = 16, qbits: int = 20, seed: int = 0) -> Dict:
    """Block-diagonal matvec with block 0's NTT domain perturbed: the
    corruption is confined to that block but total within it."""
    q = numth.find_ntt_prime(block, qbits)
    psi = numth.psi_negacyclic(block, q)
    rng = random.Random(seed)
    x = [rng.randrange(q) for _ in range(dim)]
    out_clean, out_noisy = [], []
    for b0 in range(0, dim, block):
        h = oracle.negacyclic_ntt(x[b0:b0 + block], psi, q)
        out_clean += oracle.negacyclic_intt(h, psi, q)
        h2 = list(h)
        if b0 == 0:
            h2[0] = (h2[0] + 1) % q
        out_noisy += oracle.negacyclic_intt(h2, psi, q)
    disturbed = sum(1 for a, b in zip(out_clean, out_noisy) if a != b)
    return {"dim": dim, "block": block, "disturbed": disturbed,
            "confined_to_block": disturbed <= block}


def baseconv_smear(limbs: int = 4, bits: int = 12, n_el: int = 32, seed: int = 0) -> Dict:
    rng = random.Random(seed)
    moduli = numth.generate_crt_primes(limbs, bits, rng)
    P = math.prod(moduli)
    xs = [rng.randrange(P) for _ in range(n_el)]
    residues = [[x % p for x in xs] for p in moduli]
    out_moduli = numth.generate_crt_primes(2, 2 * bits, rng)
    clean = oracle.base_conv(residues, moduli, out_moduli)
    residues[1][5] ^= 4                      # flip one residue bit
    noisy = oracle.base_conv(residues, moduli, out_moduli)
    per_elem = [clean[i] != noisy[i] for i in range(n_el)]
    return {"elements_disturbed": sum(per_elem),
            "confined_to_element": sum(per_elem) == 1,
            "all_out_limbs_disturbed": noisy[5] != clean[5]}


def grouped_crt_check(limbs: int = 6, group: int = 2, bits: int = 20, seed: int = 0) -> Dict:
    """Reconstruct x from grouped moduli and check x mod Q_k against the
    grouped residue."""
    rng = random.Random(seed)
    moduli = numth.generate_crt_primes(limbs, bits, rng)
    x = rng.randrange(math.prod(moduli))
    groups = [math.prod(moduli[i:i + group]) for i in range(0, limbs, group)]
    ok = all((x % Qk) == oracle.base_conv([[x % p] for p in moduli], moduli, [Qk])[0][0] % Qk
             for Qk in groups)
    return {"groups": len(groups), "consistent": ok}


def plaintext_perturb(n: int = 256, seed: int = 5, device: str = "cuda") -> Dict:
    """+1 on one NTT-domain plaintext coefficient (limb 0, slot 0) before a
    homomorphic plaintext multiply: the slots disturbed after decryption."""
    from ..fhe.bgv import BgvContext
    from ..fhe.params import BgvParams
    from ..fhe.rns import RnsPoly, poly_ntt
    bgv = BgvContext(BgvParams.make(n=n, levels=1, q_bits=30, t_bits=16), seed=seed,
                     device=device)
    rng = np.random.default_rng(seed)
    m1 = rng.integers(0, bgv.t, (2, n // 2), dtype=np.uint32)
    m2 = rng.integers(0, bgv.t, (2, n // 2), dtype=np.uint32)
    ct = bgv.encrypt(bgv.encode(m1))
    pt_ntt = poly_ntt(RnsPoly(bgv.encode(m2).data, False), bgv.ctx)
    clean = bgv.decrypt_decode(bgv.multiply_plain(ct, pt_ntt))
    data = pt_ntt.data.clone()
    data[0, 0] = (data[0, 0] + 1) % bgv.params.moduli[0]
    noisy = bgv.decrypt_decode(bgv.multiply_plain(ct, RnsPoly(data, True)))
    disturbed = int((clean != noisy).sum())
    return {"slots": n, "disturbed": disturbed, "fraction": disturbed / n}


def demos(device: str = "cuda") -> Dict[str, Dict]:
    """The six demos' dicts, in `main`'s order."""
    return {"ntt_smear": ntt_smear(), "fft_smear": fft_smear(),
            "bsgs_block_smear": bsgs_block_smear(), "baseconv_smear": baseconv_smear(),
            "grouped_crt_check": grouped_crt_check(),
            "plaintext_perturb": plaintext_perturb(device=device)}


def main(argv=None) -> None:
    from ..device import require
    ap = argparse.ArgumentParser(description="the motivation demos")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require(args.device)
    for name, res in demos(args.device).items():
        print(f"{name}:", res)


if __name__ == "__main__":
    main()
