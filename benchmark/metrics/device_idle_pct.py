"""The share of the traced window in which nothing ran on the device, in %."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100 * (1 - t.busy_s() / t.window_s)
