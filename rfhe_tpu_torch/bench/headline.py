"""The headline: a warm CKKS rotation against the reference's SEAL CPU time.

Counterpart of the repository's `bench.py`, step for step through the
port's `CkksContext`: N=4096 with 21 ciphertext primes and one special
prime, seed 7; one warm rotation, which draws the Galois key and builds the
kernels; a gate that refuses to report unless that rotation decrypts to the
rotated slots within 1e-3; then `iters` rotations queued back to back and
one synchronise, the host clock around them.  On the card the rotation runs
the hand NTT kernels (the one-block K1 and K2 at N=4096); `--device cpu`
runs their plain versions, with the host's times.

On the card each rotation is one replay of the op's CUDA graph
(`utils/jitcache.py`), as each is one jit program in the reference; a line
before the JSON line gives the same rotation under `jitcache.eager()` (the
op's kernels launched one by one), with the card's name and power limit.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", "card"}: the
metric is the reference's name behind the device prefix
(`h100_ckks_rotation_n4096_L21_latency` on the card), `card` the card's name
and power limit as nvidia-smi gives them ("cpu" on the CPU).  Any failure
exits nonzero, a missing card included.

Usage: python -m rfhe_tpu_torch.bench.headline [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import card, require
from ..fhe import CkksContext, CkksParams
from ..utils.jitcache import eager
from .sweeps import prefix

BASELINE_ROTATION_US = 14_377.0   # SEAL 4.1, N=4096, 21 limbs (CPU): bench.py:22


def rotation_bench(n: int = 4096, levels: int = 20, iters: int = 30, device="cuda") -> dict:
    """`bench.py:rotation_bench` on `device`; raises RuntimeError when the
    warm rotation does not decrypt to np.roll(z, -1) within 1e-3."""
    dev = require(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    params = CkksParams.make(n=n, levels=levels, q0_bits=30, scale_bits=28)
    ckks = CkksContext(params, seed=7, device=dev)
    rng = np.random.default_rng(0)
    z = rng.uniform(-1, 1, n // 2) + 0j
    ct = ckks.encrypt(*ckks.encode(z))
    r = ckks.rotate(ct, 1)          # builds the galois key (and loads the kernels)
    sync()
    back = ckks.decrypt_decode(r)
    if not np.allclose(back, np.roll(z, -1), atol=1e-3):
        raise RuntimeError("rotation output mismatch — refusing to report")
    t0 = time.perf_counter()
    for _ in range(iters):
        r = ckks.rotate(ct, 1)
    sync()
    us = (time.perf_counter() - t0) / iters * 1e6
    return {
        "metric": f"{prefix(dev.type)}ckks_rotation_n{n}_L{levels + 1}_latency",
        "value": round(us, 1),
        "unit": "us",
        "vs_baseline": round(BASELINE_ROTATION_US / us, 2),
        "card": card() if dev.type == "cuda" else "cpu",
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    # any exception propagates: exit nonzero
    if require(args.device).type == "cuda":
        with eager():
            e = rotation_bench(device=args.device)
        print(f"eager (no graphs): {e['value']} us per warm rotation, vs_baseline "
              f"{e['vs_baseline']}, on {e['card']}")
    out = rotation_bench(device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
