"""idle_share.rvt: 100 x (1 - union of the device's activity intervals
/ wall) over the profiled slice in the middle of the measured window."""


def read(run):
    prof = run.profile
    if not prof or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
