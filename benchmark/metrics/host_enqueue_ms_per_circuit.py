"""The host's time to enqueue a circuit: the benchmark's own span from its
first call to its last call's return, before the synchronise (traced run)."""


def read(run):
    t = run.trace
    if t is None or not t.enqueue_s:
        return None
    return sum(t.enqueue_s) / len(t.enqueue_s) * 1e3
