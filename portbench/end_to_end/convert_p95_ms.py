"""The 95th percentile of the latency of every call completed in the
window, from call to returned waveform (linear interpolation between
order statistics)."""

import numpy as np


def read(r):
    return float(np.percentile(r.result["latency_ms"], 95)) if r.result["latency_ms"] else None
