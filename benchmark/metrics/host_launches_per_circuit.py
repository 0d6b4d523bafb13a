"""Host launch records per circuit: kernel launches, graph launches and
copies (`yardstick.LAUNCH_CALLS`, the calls `rfhe_tpu_torch/device.py`
counts), from the traced window."""


def read(run):
    t = run.trace
    if t is None or not t.circuits or not t.launches:
        return None
    return t.launches / t.circuits
