"""Op-level tracing (reference-format ROI markers), the reference's trace
post-processors, the phase-decomposed profiled rotation and the measured
op cost (counterpart of `rfhe_tpu/trace/`), and the spans and counters
inside the port's own layers (`spans`).

`spans` is imported by `device.py`, the graph cache and the evaluators,
which `profiled` and `cost` import in turn: their names load at first use,
so that importing this package imports neither."""
from . import spans  # noqa: F401
from .markers import TraceCollector, TraceEvent  # noqa: F401
from .analyze import collapse_kernel_runs, summarize_roi  # noqa: F401

_LAZY = {"ProfiledRotation": "profiled", "op_cost": "cost",
         "evaluator_cost_report": "cost", "format_report": "cost"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
