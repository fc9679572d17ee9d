"""forward_ms.rvt: host ms a window from the chunk's call into RVT's
``detect`` to its decoded predictions on the host (the driver's
``forward`` span), all forward time over all windows."""


def read(run):
    windows = sum(r["windows"] for r in run.records)
    spent = sum(r.get("spans", {}).get("forward", 0.0) for r in run.records)
    if not windows or not spent:
        return None
    return spent / windows * 1e3
