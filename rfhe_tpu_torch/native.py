"""ctypes binding of the native Monte-Carlo engine, `native/rfhe_mc.cpp`.

Counterpart of `rfhe_tpu/native.py`, with its functions and arguments: host
campaigns at butterfly-op granularity (OpenMP), beside the device campaigns
of `faults/`.  At first use the source is compiled with
`g++ -O3 -fopenmp -std=c++17 -shared -fPIC` into `build/native/` of the
checkout, into a library named by the hash of the source and the flags; the
committed `native/` is only read.  A missing compiler raises.

The engine seeds each OpenMP thread from (seed, thread id), so its counts
depend on the thread count: two runs agree where OMP_NUM_THREADS agrees.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path
from typing import Dict

from .numth import primitive_root

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "native" / "rfhe_mc.cpp"
BUILD_DIR = ROOT / "build" / "native"
FLAGS = ("-O3", "-fopenmp", "-std=c++17", "-shared", "-fPIC")

FAULT_IDS = {"SCF-BF": 0, "SCF-MBU": 1, "MCF-PPE": 2, "MCF-CTE": 3, "MCF-CLE": 4}

#: scenario name -> native kind-code list (relia_ntt_sim.cpp:401-405)
SCENARIOS = {
    "SBF": [0], "DBF": [1], "MLF": [2], "MOF1": [2],
    "SBF+SBF": [0, 0], "SBF+DBF": [0, 1],
    "MLF+SBF": [2, 0], "MLF+DBF": [2, 1], "MLF+MLF": [2, 2],
}


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"librfhe_mc_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the engine if the library of this source is missing; returns
    its path."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native engine is built from native/rfhe_mc.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *FLAGS, str(SOURCE), "-o", str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ll, u64, i, ptr = ctypes.c_longlong, ctypes.c_uint64, ctypes.c_int, ctypes.POINTER
    lib.four_step_mc_multi.argtypes = [ll, ll, u64, u64, i, ptr(i), i, i, u64, ptr(ll)]
    lib.three_stage_mc.argtypes = [ll, ll, u64, i, i, u64, ptr(ll)]
    lib.montgomery_mc.argtypes = [ll, i, ll, i, i, i, i, i, u64, ptr(ll)]
    lib.barrett_final_mc.argtypes = [ll, i, i, i, i, i, i, ll, u64, ptr(ll)]
    for fn in (lib.four_step_mc_multi, lib.three_stage_mc, lib.montgomery_mc, lib.barrett_final_mc):
        fn.restype = None
    return lib


def four_step_mc(kind: str, trials: int, n: int, q: int, fold_width: int = 24, seed: int = 42,
                 target_stage: int | None = None) -> Dict:
    """The protected four-step NTT at butterfly-op granularity: `kind` a
    SCENARIOS name, all faults at distinct ops; target_stage None anywhere in
    the transform, 0/1/2 that stage's op range."""
    codes = SCENARIOS[kind]
    arr = (ctypes.c_int * len(codes))(*codes)
    out = (ctypes.c_longlong * 6)()
    _lib().four_step_mc_multi(trials, n, q, primitive_root(q), fold_width, arr, len(codes),
                              -1 if target_stage is None else target_stage, seed, out)
    detected = out[0]
    return {
        "det_rate": detected / trials,
        "miss_rate": 1.0 - detected / trials,
        "stats": {"batch1_catch": out[1], "intra_catch": out[2], "inter_catch": out[3],
                  "batch2_catch": out[4], "batch_catch": out[1] + out[4]},
    }


def four_step_scenario_table(trials: int, n: int, q: int, fold_width: int = 24,
                             seed: int = 42) -> list:
    """Every (scenario, stage) row (reliaNTT_test_result.txt layout)."""
    rows = []
    for sc in ("SBF", "DBF", "MLF", "SBF+SBF", "SBF+DBF", "MLF+SBF", "MLF+DBF", "MLF+MLF"):
        for stage in (0, 1, 2):
            res = four_step_mc(sc, trials, n, q, fold_width, seed, target_stage=stage)
            rows.append({"scenario": sc, "stage": stage, "det_rate": res["det_rate"],
                         "miss_rate": res["miss_rate"], **res["stats"]})
    return rows


def three_stage_mc(ftype: str, trials: int, S: int, P: int, W: int, seed: int = 42) -> Dict:
    """The three-stage pipeline (matmul, elementwise fold, matmul)."""
    out = (ctypes.c_longlong * 6)()
    _lib().three_stage_mc(trials, S, P, W, FAULT_IDS[ftype], seed, out)
    inj = [out[i] for i in range(3)]
    und = [out[3 + i] for i in range(3)]
    return {"injected": inj, "undetected": und,
            "collision_prob": [u / i if i else 0.0 for u, i in zip(und, inj)]}


def montgomery_mc(fold_width: int, scheme, trials: int, pbits: int = 37, vec_len: int = 8192,
                  flip_count: int = 2, seed: int = 42) -> Dict:
    """The Montgomery campaign (`faults/reduction_campaigns.montgomery_campaign`'s
    semantics) at archive trial counts."""
    use_m, use_mp, use_final = (list(scheme) + [False, False])[:3]
    out = (ctypes.c_longlong * 2)()
    _lib().montgomery_mc(trials, pbits, vec_len, fold_width, int(use_m), int(use_mp),
                         int(use_final), flip_count, seed, out)
    TP, FN = out[0], out[1]
    return {"detection_rate": TP / (TP + FN) if TP + FN else 1.0, "TP": TP, "FN": FN}


def barrett_final_mc(s_bits: int, fault_model: int, trials: int, pbits: int = 37,
                     vec_len: int = 8192, use_intra: bool = True, use_range: bool = True,
                     use_sum: bool = True, seed: int = 1) -> Dict:
    """The barrett_final campaign (Intra / Range / Sum, four fault models)."""
    out = (ctypes.c_longlong * 4)()
    _lib().barrett_final_mc(trials, pbits, s_bits, fault_model, int(use_intra), int(use_range),
                            int(use_sum), vec_len, seed, out)
    und, intra_only, inter_only, both = out[0], out[1], out[2], out[3]
    return {"miss_rate": und / trials if trials else 0.0, "det_intra_only": intra_only,
            "det_sum_only": inter_only, "det_both": both, "undetected": und}
