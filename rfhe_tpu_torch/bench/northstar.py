"""North-star shape measurements on the card.

Counterpart of `rfhe_tpu/bench/northstar.py`:

Row 1: CKKS multiply + rescale at N = 2^16, levels 16 with the composite scale
       2^56 (two 28-bit primes per level, a rescale drops both): 34
       ciphertext limbs and one special prime, seed 7.  The multiply is the
       tensor product alone, so no relinearization key is drawn.
Row 2: the BGV encrypted dot product at N = 16384, 10 x 30-bit limbs, t of 20
       bits, seed 11, messages from default_rng(1): the reference's real-GPU
       campaign configuration (reliability_test/dotprod_test.cu:198-204).

`warm_ms` is the host clock over back-to-back calls after a warm one, the
device waited for before the clock stops; `setup_s` is the context, keys,
encryption and first call (the reference's `setup_compile_s`).  The CKKS
row's `max_err` is the largest slot error of the decoded product against
z·z; the BGV row is exact when every slot decrypts to Σ x·y mod t.

Usage: python -m rfhe_tpu_torch.bench.northstar [--only ckks|bgv]
           [--device cuda] [--out results]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..device import host_us, require
from .ops_devtime import write_csv
from .sweeps import prefix

CKKS = dict(n=65536, levels=16, q0_bits=31, scale_bits=56)
CKKS_SEED = 7
BGV = dict(n=16384, levels=9, q_bits=30, t_bits=20)
BGV_SEED = 11
COLUMNS = ["workload", "n", "limbs", "warm_ms", "max_err", "setup_s", "exact"]


def ckks_case(device, params: dict = CKKS, seed: int = CKKS_SEED):
    """(context, z, ciphertext of z, rescale(multiply(ct, ct)))."""
    from ..fhe import CkksContext, CkksParams
    ckks = CkksContext(CkksParams.make(**params), seed=seed, device=device)
    n = params["n"]
    rng = np.random.default_rng(0)
    z = rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)
    ct = ckks.encrypt(*ckks.encode(z))
    return ckks, z, ct, ckks.rescale(ckks.multiply(ct, ct))


def ckks_row(device="cuda", iters: int = 10):
    """(row, product ciphertext)."""
    dev = require(device)
    t0 = time.perf_counter()
    ckks, z, ct, m = ckks_case(dev)
    setup_s = time.perf_counter() - t0
    err = float(np.max(np.abs(ckks.decrypt_decode(m) - z * z)))
    ms = host_us(lambda: ckks.rescale(ckks.multiply(ct, ct)), dev, iters) / 1e3
    return {"workload": "ckks_mult_rescale", "n": ckks.params.n, "limbs": ckks.L,
            "warm_ms": ms, "max_err": f"{err:.2e}", "setup_s": setup_s,
            "exact": err < 1e-6}, m


def bgv_case(device, params: dict = BGV, seed: int = BGV_SEED):
    """(context, m1, m2, ct_x, ct_y, dot_product_bgv(ct_x, ct_y))."""
    from ..fhe import BgvContext, BgvParams
    from ..models.dotprod import dot_product_bgv
    bgv = BgvContext(BgvParams.make(**params), seed=seed, device=device)
    n = params["n"]
    rng = np.random.default_rng(1)
    m1 = rng.integers(0, bgv.t, (2, n // 2), dtype=np.uint32)
    m2 = rng.integers(0, bgv.t, (2, n // 2), dtype=np.uint32)
    ct_x = bgv.encrypt(bgv.encode(m1))
    ct_y = bgv.encrypt(bgv.encode(m2))
    return bgv, m1, m2, ct_x, ct_y, dot_product_bgv(bgv, ct_x, ct_y)


def bgv_row(device="cuda", iters: int = 5):
    """(row, dot-product ciphertext)."""
    from ..models.dotprod import dot_product_bgv
    dev = require(device)
    t0 = time.perf_counter()
    bgv, m1, m2, ct_x, ct_y, out = bgv_case(dev)
    setup_s = time.perf_counter() - t0
    got = bgv.decrypt_decode(out)
    expect = int((m1.astype(object) * m2.astype(object)).sum()) % bgv.t
    exact = bool((got == expect).all())
    ms = host_us(lambda: dot_product_bgv(bgv, ct_x, ct_y), dev, iters) / 1e3
    return {"workload": "bgv_dotprod", "n": bgv.params.n, "limbs": bgv.params.L,
            "warm_ms": ms, "max_err": "0" if exact else "MISMATCH", "setup_s": setup_s,
            "exact": exact}, out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=["ckks", "bgv"], default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="results")
    args = ap.parse_args(argv)
    require(args.device)
    rows = []
    if args.only in (None, "ckks"):
        rows.append(ckks_row(args.device)[0])
    if args.only in (None, "bgv"):
        rows.append(bgv_row(args.device)[0])
    write_csv(os.path.join(args.out, prefix(args.device) + "northstar.csv"), COLUMNS, rows)
    if not all(r["exact"] for r in rows):
        raise SystemExit("north-star correctness FAILED")


if __name__ == "__main__":
    main()
