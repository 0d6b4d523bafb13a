"""Device ms per circuit in the program's span BASECONV: the keyswitch's
digits (`compute_digits`: per-limb digits, or each group's fast base
extension, ModUp), timed on the card by the span's marks
(`rfhe_tpu_torch/trace/spans.py`), traced run."""


def read(run):
    e = (run.spans or {}).get("BASECONV")
    if not e or not e["device_ns"] or not run.ends:
        return None
    return e["device_ns"] / len(run.ends) * 1e-6
