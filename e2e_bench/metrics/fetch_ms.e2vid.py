"""fetch_ms.e2vid: host ms a window spent in the reconstruct CLI's chunk
fetch (the program's span ``reconstruct.fetch``: dataset items, their voxel
grids, padding, the stack), all fetch time over all windows. Nothing where
the program has no such span."""


def read(run):
    windows = sum(r["windows"] for r in run.records)
    spent = sum(r.get("program", {}).get("spans", {})
                .get("reconstruct.fetch", 0.0) for r in run.records)
    if not windows or not spent:
        return None
    return spent / windows * 1e3
