"""Device ms per circuit of the kernels that are neither NTT kernels nor
copies or fills: the residue arithmetic (`ops/modarith.py`, the dyadic key
product and digit sums of `fhe/keys.py`, `fhe/rns.py`)."""
from benchmark import yardstick


def read(run):
    t = run.trace
    if t is None or not t.circuits:
        return None
    s = t.device_s(lambda n: not yardstick.is_ntt(n) and not yardstick.is_copy(n))
    return s * 1e3 / t.circuits if s > 0 else None
