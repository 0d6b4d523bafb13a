"""Device ms per circuit of `csrc/ntt.cu`'s `ntt_*_kernel` kernels."""
from benchmark import yardstick


def read(run):
    t = run.trace
    if t is None or not t.circuits:
        return None
    s = t.device_s(yardstick.is_ntt)
    return s * 1e3 / t.circuits if s > 0 else None
