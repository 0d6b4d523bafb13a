"""Device ms per circuit in the protected evaluator's detector spans
(`CHK_PERMUTE` ... `CHK_MD_RANGE`, `spans.CHECK_PHASES` in
`rfhe_tpu_torch/trace/spans.py`): each ABFT check of `fhe/protected.py`
after the step it guards, timed on the card by the spans' marks, traced
run.  The tensor product's `dyadic` check runs inside its products and has
no span of its own."""

PHASES = ("CHK_PERMUTE", "CHK_INTT", "CHK_BASECONV", "CHK_KS_CORE", "CHK_MD_INTT",
          "CHK_MD_LIFT", "CHK_MD_PROJ", "CHK_MD_RANGE")


def read(run):
    spans = run.spans or {}
    ns = [spans[p]["device_ns"] for p in PHASES if p in spans]
    if not any(ns) or not run.ends:
        return None
    return sum(ns) / len(run.ends) * 1e-6
