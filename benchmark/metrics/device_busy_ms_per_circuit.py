"""Device ms per circuit in which a kernel or a copy ran: the union of
their intervals in the traced window."""


def read(run):
    t = run.trace
    if t is None or not t.circuits:
        return None
    busy = t.busy_s()
    return busy * 1e3 / t.circuits if busy > 0 else None
