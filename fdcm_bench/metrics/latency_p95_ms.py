"""95th percentile latency of every request completed in the window, from
submit to the answer's list of matches."""
import numpy as np


def read(run):
    lat = [d.latency_s for d in run.record.done]
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
