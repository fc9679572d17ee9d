"""window_fetch_ms.stream: host ms a window spent in the data loader (the
driver's ``window_fetch`` span), all fetch time over all windows."""


def read(run):
    windows = sum(r["windows"] for r in run.records)
    if not windows:
        return None
    spent = sum(r["spans"].get("window_fetch", 0.0) for r in run.records)
    return spent / windows * 1e3
