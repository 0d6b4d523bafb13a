"""Each cell cut to a ring the CPU runs in a second: the same configuration,
mix and limits, at n = 256 and three or four primes.  Besides the cells of
BENCHMARK.json, the cells whose files `benchmark/` keeps for a later benchmark
(PERF.md, Open questions: the channel mix and the BGV dot products) run here
too."""
import time

from benchmark import harness

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
KEPT = {"configs": [{"name": "bgv_n16384_l10", "file": "benchmark/configs/bgv_n16384_l10.json"}],
        "workloads": [{"name": f"{c}.{t}", "config": c, "traffic": t, "chips": 1}
                      for c, t in (("ckks_n65536_l21", "chanmix_c64"),
                                   ("bgv_n16384_l10", "dotprod"),
                                   ("bgv_n16384_l10", "dotprod_protected"))]}
SPEC_ALL = {**SPEC, "configs": SPEC["configs"] + KEPT["configs"],
            "workloads": SPEC["workloads"] + KEPT["workloads"]}
CELLS = [w["name"] for w in SPEC_ALL["workloads"]]
TINY = {"ckks": {"n": 256, "levels": 3}, "bgv": {"n": 256, "levels": 3, "t_bits": 16}}
TINY_MIX = {"d": 16, "channels": 4}


def parts(name: str, spec: dict = SPEC_ALL, root=harness.ROOT) -> tuple:
    w, cfg, mix, limits = harness.cell(spec, name, root)
    cfg["deployment"].update(TINY[cfg["deployment"]["scheme"]])
    mix.update({k: v for k, v in TINY_MIX.items() if k in mix})
    return w, cfg, mix, limits


def run(name: str, seed: int = 2 ** 31 + 11, seconds: float = 0.3, control=False,
        cut=None):
    """(correct, failed, checks, Run) of one tiny run on the CPU."""
    cut = cut or parts(name)
    r, per_sample, extra, limits = harness.run_cell(cut, seed, seconds, False, "cpu",
                                                     time.perf_counter(), control)
    return (*harness.judgement(per_sample, extra, limits), r)
