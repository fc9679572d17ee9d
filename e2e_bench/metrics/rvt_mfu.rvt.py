"""rvt_mfu.rvt: the network's share of the card's peak, in %: windows
through it (the program's counter ``rvt.windows``) times its operations a
window (``flops_per_window`` of the configuration's reference: 2 x the
multiply-adds of every convolution, LSTM gate and linear layer, and of the
attention's two products) over the records' seconds, over 67 TFLOP/s,
the dense float32 peak of an H100 SXM outside the tensor cores (NVIDIA's
data sheet; the configuration runs float32 with TF32 off). The share of
the whole step: the records' seconds hold the fetch too. Nothing where
the program has no such counter."""

PEAK_FLOPS = 67e12


def read(run):
    windows = sum(r.get("program", {}).get("counts", {})
                  .get("rvt.windows", 0) for r in run.records)
    if not windows or run.seconds <= 0:
        return None
    ref = run.bench.reference(run.ctx.cfg["name"])
    flops = windows * ref.flops_per_window(run.ctx.cfg)
    return 100.0 * flops / run.seconds / PEAK_FLOPS
