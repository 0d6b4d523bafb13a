"""Op-level tracing (reference-format ROI markers), the reference's trace
post-processors, the phase-decomposed profiled rotation and the measured
op cost (counterpart of `rfhe_tpu/trace/`)."""
from .markers import TraceCollector, TraceEvent, torch_trace  # noqa: F401
from .analyze import collapse_kernel_runs, summarize_roi  # noqa: F401
from .profiled import ProfiledRotation  # noqa: F401
from .cost import op_cost, evaluator_cost_report, format_report  # noqa: F401
