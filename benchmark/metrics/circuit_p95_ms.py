"""The 95th percentile of every circuit's latency in the window, from its
first call to the synchronise after its last (host clock)."""
import numpy as np


def read(run):
    lat = np.subtract(run.ends, run.starts) * 1e3
    return float(np.percentile(lat, 95))
