"""scatter_launches_per_window.cmax: launches of the program's hand-written
scatter kernels (``ops.cuda_scatter.launch_counts()``, summed over routes)
a window. On the solver paths one launch is one loss evaluation."""


def read(run):
    windows = sum(r["windows"] for r in run.records)
    if not windows:
        return None
    launches = sum(sum(r.get("launches", {}).values()) for r in run.records)
    return launches / windows
