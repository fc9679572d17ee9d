"""fetch_ms.eraft: host ms a window spent in the flow CLI's chunk fetch
(the program's span ``reconstruct.fetch``: dataset items, their voxel grids
in one batched build, padding, the stack, the copy back), all fetch time
over the windows it built (the program's counter
``reconstruct.batched_windows``: a chunk's new windows; the grid carried
from the chunk before is not built again). Nothing where the program has
no such span or counter."""


def read(run):
    counts = [r.get("program", {}) for r in run.records]
    windows = sum(p.get("counts", {}).get("reconstruct.batched_windows", 0)
                  for p in counts)
    spent = sum(p.get("spans", {}).get("reconstruct.fetch", 0.0)
                for p in counts)
    if not windows or not spent:
        return None
    return spent / windows * 1e3
