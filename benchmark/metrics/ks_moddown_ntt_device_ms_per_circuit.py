"""Device ms per circuit in the program's spans MD_INTT and MD_NTT: the
transforms of the keyswitch's mod-down, each `drop_limb`'s inverse NTT of
the special limb and forward NTT of δ over the kept limbs, timed on the
card by the spans' marks (`rfhe_tpu_torch/trace/spans.py`), traced run."""

PHASES = ("MD_INTT", "MD_NTT")


def read(run):
    spans = run.spans or {}
    ns = [spans[p]["device_ns"] for p in PHASES if p in spans]
    if not any(ns) or not run.ends:
        return None
    return sum(ns) / len(run.ends) * 1e-6
