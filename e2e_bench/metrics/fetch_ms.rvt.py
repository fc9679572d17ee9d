"""fetch_ms.rvt: host ms a window spent in the detection CLI's chunk fetch
(the program's span ``reconstruct.fetch``: dataset items, their stacked
histograms in one batched build on the card, padding and the stack, handed
over there), all fetch time over the windows through the network (the
program's counter ``rvt.windows``; each window is fetched once). Nothing
where the program has no such span or counter."""


def read(run):
    counts = [r.get("program", {}) for r in run.records]
    windows = sum(p.get("counts", {}).get("rvt.windows", 0) for p in counts)
    spent = sum(p.get("spans", {}).get("reconstruct.fetch", 0.0)
                for p in counts)
    if not windows or not spent:
        return None
    return spent / windows * 1e3
