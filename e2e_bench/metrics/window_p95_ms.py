"""window_p95_ms: the 95th percentile (linear between order statistics),
over every window completed inside the measured window, of the time from
asking the loader for the window to having its result on the host, in ms
(host clock). A closed loop: each window follows the last."""

import numpy as np


def read(run):
    lat = [r["t1"] - r["t0"] for r in run.records if r["windows"] == 1]
    if not lat:
        return None
    return float(np.percentile(lat, 95)) * 1e3
