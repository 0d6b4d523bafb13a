"""Device ms per circuit in the program's spans MD_LIFT and MD_SCALE: the
int64 residue passes of the keyswitch's mod-down, each `drop_limb`'s
centred lift of the special limb to the kept limbs and its subtract and
scale by q_src⁻¹, timed on the card by the spans' marks
(`rfhe_tpu_torch/trace/spans.py`), traced run."""

PHASES = ("MD_LIFT", "MD_SCALE")


def read(run):
    spans = run.spans or {}
    ns = [spans[p]["device_ns"] for p in PHASES if p in spans]
    if not any(ns) or not run.ends:
        return None
    return sum(ns) / len(run.ends) * 1e-6
