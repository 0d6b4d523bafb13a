"""The phase-decomposed profiled rotation.

Counterpart of `rfhe_tpu/trace/profiled.py`.  The reference obtains
per-kernel cost breakdowns by patching SEAL to print [NTT] / [MODREDUCTION]
/ [MULTEVK] timings inside each frontend op (build/sample.txt).  The
profiled rotation runs `CkksContext.rotate` itself, the program's own
graphed op, with the spans of the main path on (`trace/spans.py`), and
writes each phase's time in the reference's kernel-line format:

  PERMUTE   Galois slot permutation of c0 and c1
  INTT      c1 back to the coefficient domain
  BASECONV  digit decomposition and extension to the (Q, P) basis
  NTT       forward NTTs of all digits
  MULTEVK   dyadic MAC against the key and the digit sum
  MODDOWN   divide-and-round by the special primes

These are `spans.PHASES`, opened by `fhe/ckks.py` and `fhe/keys.py`; inside
MODDOWN each special prime's `drop_limb` closes `spans.MODDOWN_PHASES`.  A
phase's time is read from the clock its spans used: the card's on a CUDA
device (each graph replay adds the phases it ran), the host's on the CPU.
The final c0 + δ add lies in no phase, as in the benchmark's spans.  The
first call of a signature with tracing on runs the op's eager warm run
before its graph is captured (`utils/jitcache.py`): that call times the
eager run.  The Galois key is drawn before the spans are read, so key
generation lands in no phase.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..fhe.ckks import Ciphertext, CkksContext
from . import spans
from .markers import TraceCollector
from .spans import PHASES


class ProfiledRotation:
    def __init__(self, ckks: CkksContext):
        self.ckks = ckks
        self.last_collector: Optional[TraceCollector] = None

    def rotate(self, ct: Ciphertext, r: int,
               collector: Optional[TraceCollector] = None) -> Ciphertext:
        """`ckks.rotate(ct, r)` with tracing on for the context's device,
        one kernel line per phase written to `collector`; tracing is left
        as it was found."""
        ckks = self.ckks
        dev = ckks.device
        col = collector if collector is not None else TraceCollector()
        ckks.galois_key(ckks.rotation_galois_element(r))
        was_on, was_marking = spans.ENABLED, spans.MARKING
        spans.enable(dev)
        try:
            snap = spans.snapshot()
            with col.scope("ROTATE"):
                out = ckks.rotate(ct, r)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                got = spans.since(snap)
                clock = "device_ns" if dev.type == "cuda" else "host_ns"
                for name in PHASES:
                    col.kernel_cost(name, got[name][clock] / 1e3)
        finally:
            if not was_on:
                spans.disable()
            elif spans.MARKING != was_marking:
                spans.enable("cpu" if was_marking is None else torch.device("cuda", was_marking))
        self.last_collector = col
        return out

    def breakdown(self) -> Dict[str, float]:
        """Phase shares of the last rotation's times, mapped onto the
        reference's rotation categories (draw_rotation.py: NTT / ModMul /
        BaseConv / Others), as `rfhe_tpu.trace.ProfiledRotation.breakdown`."""
        tot = self.last_collector.totals()
        ntt = tot.get("NTT", 0) + tot.get("INTT", 0)
        modmul = tot.get("MULTEVK", 0)
        baseconv = tot.get("BASECONV", 0)
        others = tot.get("PERMUTE", 0) + tot.get("MODDOWN", 0)
        s = ntt + modmul + baseconv + others
        return {"NTT": ntt / s, "ModMul": modmul / s, "BaseConv": baseconv / s,
                "Others": others / s, "total_us": tot.get("ROTATE", s)}
