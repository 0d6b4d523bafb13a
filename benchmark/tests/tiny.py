"""Each cell cut to a ring the CPU runs in a second: the same configuration,
mix and limits, at n = 256 and three to five primes.  Besides the cells of
BENCHMARK.json, the cells whose files `benchmark/` keeps for a later benchmark
(PERF.md, Open questions: the channel mix and the BGV dot products) run here
too, and `bfv_cell` gives a BFV cell as the files a later one would add."""
import math
import time

from benchmark import harness
from benchmark.reference import scheme

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
KEPT = {"configs": [{"name": "bgv_n16384_l10", "file": "benchmark/configs/bgv_n16384_l10.json"}],
        "workloads": [{"name": f"{c}.{t}", "config": c, "traffic": t, "chips": 1}
                      for c, t in (("ckks_n65536_l21", "chanmix_c64"),
                                   ("bgv_n16384_l10", "dotprod"),
                                   ("bgv_n16384_l10", "dotprod_protected"))]}
SPEC_ALL = {**SPEC, "configs": SPEC["configs"] + KEPT["configs"],
            "workloads": SPEC["workloads"] + KEPT["workloads"]}
CELLS = [w["name"] for w in SPEC_ALL["workloads"]]
# BFV's five primes leave the depth-3 product tree's noise (83 bits) far under Δ/2 (2^133).
TINY = {"ckks": {"n": 256, "levels": 3}, "bgv": {"n": 256, "levels": 3, "t_bits": 16},
        "bfv": {"n": 256, "levels": 4, "t_bits": 16}}
TINY_MIX = {"d": 16, "channels": 4}


def parts(name: str, spec: dict = SPEC_ALL, root=harness.ROOT) -> tuple:
    if name == BFV_CELL:
        return bfv_parts()
    w, cfg, mix, limits = harness.cell(spec, name, root)
    cfg["deployment"].update(TINY[cfg["deployment"]["scheme"]])
    mix.update({k: v for k, v in TINY_MIX.items() if k in mix})
    return w, cfg, mix, limits


def run(name: str, seed: int = 2 ** 31 + 11, seconds: float = 0.3, control=False,
        cut=None, root=harness.ROOT):
    """(correct, failed, checks, Run) of one tiny run on the CPU."""
    cut = cut or parts(name)
    r, per_sample, extra, limits = harness.run_cell(cut, seed, seconds, False, "cpu",
                                                     time.perf_counter(), control, root)
    return (*harness.judgement(per_sample, extra, limits), r)


BFV_CELL = "bfv_tiny.tree8"


def bfv_cell() -> tuple:
    """({path under benchmark/: JSON object}, {BENCHMARK.json section: entry})
    of a tiny BFV cell that BENCHMARK.json does not hold: the product tree of
    8 inputs, its control in int32 words, noise_bits limited by log2(Δ/2)."""
    dep = {"scheme": "bfv", "q_bits": 30, "special_prime_bits": 30, "digits": "per_limb",
           "sigma": 3.2, **TINY["bfv"]}
    basis = scheme.Basis.make(dep, "cpu")
    half_delta = math.prod(basis.ct) // basis.t / 2
    files = {
        "configs/bfv_tiny.json": {
            "name": "bfv_tiny", "reduced": [], "deployment": dep,
            "guarantees": "every slot exact mod t",
            "control": {"prod_dtype": "int32", "why": "the product in int32 words"}},
        "traffic/tree8.json": {"kind": "product_tree", "inputs": 8, "pool": 2, "sample": 2},
        f"limits/{BFV_CELL}.json": {"slot_mismatch": 0, "noise_bits": math.log2(half_delta)}}
    entries = {
        "configs": {"name": "bfv_tiny", "source": "a test",
                    "file": "benchmark/configs/bfv_tiny.json", "reduced": [], "why": "a test"},
        "workloads": {"name": BFV_CELL, "config": "bfv_tiny", "traffic": "tree8", "chips": 1,
                      "why": "a test"}}
    return files, entries


def bfv_parts() -> tuple:
    """`harness.cell`'s parts of the tiny BFV cell, without its files."""
    files, entries = bfv_cell()
    return (entries["workloads"], files["configs/bfv_tiny.json"], files["traffic/tree8.json"],
            files[f"limits/{BFV_CELL}.json"])
