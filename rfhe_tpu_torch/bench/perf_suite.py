"""Evaluator performance suite (profile_framewk/src/framewk.cpp analog):
times every evaluator op for CKKS, BGV, and BFV and prints the familiar
"Average <op>: N microseconds" lines, plus a MicroTest-style registry
(include/microtest.h) for ad-hoc micro-benchmarks.

Counterpart of `rfhe_tpu/bench/perf_suite.py`.  Every timer is the host
clock over calls queued back to back, stopped after the device has finished
them (`torch.cuda.synchronize()` on the card), as the reference stops after
`jax.block_until_ready`: what a caller pays who reads the results.  The
one-shot rows (encode, encrypt, decrypt_decode) are one call each, the
device waited for.

Usage: python -m rfhe_tpu_torch.bench.perf_suite [ckks|bgv|bfv|all] [--n N]
           [--levels L] [--device cuda]
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict

import numpy as np
import torch

from ..device import host_us, require


class MicroTest:
    """Named micro-benchmark registry (microtest.h analog)."""

    registry: Dict[str, "MicroTest"] = {}

    def __init__(self, name: str, setup: Callable[[], tuple],
                 run: Callable[..., object], iters: int = 20):
        self.name = name
        self.setup = setup
        self.run = run
        self.iters = iters
        MicroTest.registry[name] = self

    def __call__(self, device="cuda") -> float:
        args = self.setup()
        return _time(lambda: self.run(*args), self.iters, device=device)


def _wait(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _time(fn, iters=10, device="cuda") -> float:
    """Host microseconds per call of `fn` over `iters` calls after one warm
    call, the device waited for before the clock stops."""
    return host_us(fn, device, iters)


def _once(fn, device) -> float:
    """Host microseconds of one call, the device waited for."""
    _wait(device)
    t0 = time.perf_counter()
    fn()
    _wait(device)
    return (time.perf_counter() - t0) * 1e6


def ckks_performance_test(n: int = 4096, levels: int = 3, iters: int = 10,
                          device="cuda") -> Dict[str, float]:
    from ..fhe import CkksContext, CkksParams
    from ..fhe import serialize as _ser
    dev = require(device)
    ckks = CkksContext(CkksParams.make(n=n, levels=levels, q0_bits=30, scale_bits=28), seed=7,
                       device=dev)
    rng = np.random.default_rng(0)
    z1 = rng.uniform(-1, 1, n // 2) + 0j
    z2 = rng.uniform(-1, 1, n // 2) + 0j
    results: Dict[str, float] = {}
    box = {}
    results["encode"] = _once(lambda: box.update(pt1=ckks.encode(z1)), dev)
    pt1, sc = box["pt1"]
    pt2, _ = ckks.encode(z2)
    results["encrypt"] = _once(lambda: box.update(ct1=ckks.encrypt(pt1, sc)), dev)
    ct1 = box["ct1"]
    ct2 = ckks.encrypt(pt2, sc)
    ckks.rlk, ckks.galois_key(ckks.rotation_galois_element(1))      # keys before any timing
    ckks.galois_key(ckks.rotation_galois_element(13)), ckks.galois_key(2 * n - 1)
    results["add"] = _time(lambda: ckks.add(ct1, ct2), iters, dev)
    results["multiply"] = _time(lambda: ckks.multiply(ct1, ct2), iters, dev)
    results["multiply_relin"] = _time(lambda: ckks.multiply_relin(ct1, ct2), iters, dev)
    results["multiply_plain"] = _time(lambda: ckks.multiply_plain(ct1, pt2, sc), iters, dev)
    results["square_relin"] = _time(lambda: ckks.multiply_relin(ct1, ct1), iters, dev)
    ct3 = ckks.multiply_relin(ct1, ct2)
    results["rescale"] = _time(lambda: ckks.rescale(ct3), iters, dev)
    results["rotate_one"] = _time(lambda: ckks.rotate(ct1, 1), iters, dev)
    results["rotate_random"] = _time(lambda: ckks.rotate(ct1, 13), iters, dev)
    results["conjugate"] = _time(lambda: ckks.conjugate(ct1), iters, dev)
    results["decrypt_decode"] = _once(lambda: ckks.decrypt_decode(ct1), dev)
    # serialization rows (framewk.cpp times save/save+zlib/save+zstd; lzma
    # stands in for zstd, as in the reference)
    for comp in ("none", "zlib", "lzma"):
        key = "serialize" if comp == "none" else f"serialize_{comp}"
        results[key] = _time(lambda: _ser.serialize_ciphertext(ct1, comp), iters, dev)
    return results


def _batched_suite(ctx, dev, iters: int, ops: Dict[str, object]) -> Dict[str, float]:
    """batch_encode, encrypt, the ops of `ops` (name -> f(ct1, ct2, pt2)) and
    decrypt_decode of a context of the BGV/BFV kind."""
    n = ctx.params.n
    rng = np.random.default_rng(0)
    m1 = rng.integers(0, ctx.t, (2, n // 2), dtype=np.uint32)
    m2 = rng.integers(0, ctx.t, (2, n // 2), dtype=np.uint32)
    results: Dict[str, float] = {}
    box = {}
    results["batch_encode"] = _once(lambda: box.update(pt1=ctx.encode(m1)), dev)
    pt2 = ctx.encode(m2)
    results["encrypt"] = _once(lambda: box.update(ct1=ctx.encrypt(box["pt1"])), dev)
    ct1, ct2 = box["ct1"], ctx.encrypt(pt2)
    ctx.multiply_relin(ct1, ct2), ctx.rotate_rows(ct1, 1), ctx.rotate_columns(ct1)    # keys
    for name, op in ops.items():
        results[name] = _time(lambda: op(ct1, ct2, pt2), iters, dev)
    results["decrypt_decode"] = _once(lambda: ctx.decrypt_decode(ct1), dev)
    return results


def bgv_performance_test(n: int = 4096, levels: int = 2, iters: int = 10,
                         device="cuda") -> Dict[str, float]:
    from ..fhe.bgv import BgvContext
    from ..fhe.params import BgvParams
    dev = require(device)
    bgv = BgvContext(BgvParams.make(n=n, levels=levels, q_bits=30, t_bits=16), seed=11,
                     device=dev)
    ct3 = {}

    def mod_switch(a, b, _):
        if "ct" not in ct3:
            ct3["ct"] = bgv.multiply_relin(a, b)
        return bgv.mod_switch_to_next(ct3["ct"])

    return _batched_suite(bgv, dev, iters, {
        "add": lambda a, b, _: bgv.add(a, b),
        "multiply_relin": lambda a, b, _: bgv.multiply_relin(a, b),
        "multiply_plain": lambda a, _b, p: bgv.multiply_plain(a, p),
        "mod_switch": mod_switch,
        "rotate_rows": lambda a, _b, _p: bgv.rotate_rows(a, 1),
        "rotate_columns": lambda a, _b, _p: bgv.rotate_columns(a),
    })


def bfv_performance_test(n: int = 4096, levels: int = 2, iters: int = 10,
                         device="cuda") -> Dict[str, float]:
    """BFV op timings (framewk.cpp bfv_performance_test surface)."""
    from ..fhe.bfv import BfvContext
    from ..fhe.params import BfvParams
    dev = require(device)
    bfv = BfvContext(BfvParams.make(n=n, levels=levels, q_bits=30, t_bits=16), seed=13,
                     device=dev)
    return _batched_suite(bfv, dev, iters, {
        "add": lambda a, b, _: bfv.add(a, b),
        "multiply": lambda a, b, _: bfv.multiply(a, b),
        "square": lambda a, _b, _p: bfv.square(a),
        "multiply_relin": lambda a, b, _: bfv.multiply_relin(a, b),
        "multiply_plain": lambda a, _b, p: bfv.multiply_plain(a, p),
        "rotate_rows": lambda a, _b, _p: bfv.rotate_rows(a, 1),
        "rotate_columns": lambda a, _b, _p: bfv.rotate_columns(a),
    })


def lines(scheme: str = "all", n: int = 4096, levels: int = 3, iters: int = 10,
          device="cuda"):
    """The suite's output lines, as the reference prints them."""
    if scheme in ("ckks", "all"):
        yield f"== CKKS performance (n={n}, levels={levels}) =="
        for op, us in ckks_performance_test(n, levels, iters, device).items():
            yield f"Average {op}: {us:.0f} microseconds"
    lv = min(levels, 2)
    for name, test in (("bgv", bgv_performance_test), ("bfv", bfv_performance_test)):
        if scheme in (name, "all"):
            yield f"== {name.upper()} performance (n={n}, levels={lv}) =="
            for op, us in test(n, lv, iters, device).items():
                yield f"Average {op}: {us:.0f} microseconds"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("scheme", choices=["ckks", "bgv", "bfv", "all"], nargs="?", default="all")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require(args.device)
    for line in lines(args.scheme, args.n, args.levels, args.iters, args.device):
        print(line, flush=True)


if __name__ == "__main__":
    main()
