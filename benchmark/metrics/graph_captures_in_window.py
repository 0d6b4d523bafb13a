"""CUDA graphs the program's graph cache captured inside the traced window
(`spans.COUNTS.captures`), whole window: the warm-up captures every
signature, so a capture here is compilation inside the window."""


def read(run):
    c = run.counters
    return None if c is None else c["captures"]
