"""Host ms per circuit in the program's span `dispatch`: a graphed op's call
on the host, from its arguments to its outputs' clones
(`rfhe_tpu_torch/utils/jitcache.py`), traced run."""


def read(run):
    e = (run.spans or {}).get("dispatch")
    if not e or not e["host_ns"] or not run.ends:
        return None
    return e["host_ns"] / len(run.ends) * 1e-6
