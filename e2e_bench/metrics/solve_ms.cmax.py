"""solve_ms.cmax: host ms a window spent in the contrast-max solve (the
driver's ``solve`` span, which ends in the host read of the result), all
solve time over all windows."""


def read(run):
    windows = sum(r["windows"] for r in run.records)
    spent = sum(r["spans"].get("solve", 0.0) for r in run.records)
    if not windows or not spent:
        return None
    return spent / windows * 1e3
