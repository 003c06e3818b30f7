"""95th percentile of the latency of every request due in the window, from
its due time to its result on the host (a failed request is infinite):
the tail, a per-layer reading where the mix offers more than the server
sustains and the queue grows all through the run."""
import numpy as np


def read(obs):
    lat = obs.get('latency_s')
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
