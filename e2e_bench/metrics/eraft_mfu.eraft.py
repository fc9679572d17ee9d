"""eraft_mfu.eraft: the network's share of the card's peak, in %: pairs
through it (the program's counter ``eraft.pairs``) times its operations a
pair (``flops_per_pair`` of the configuration's reference: 2 x the
multiply-adds of every convolution, as often as a pair runs it, and the
all-pairs correlation product) over the records' seconds, over 67 TFLOP/s,
the dense float32 peak of an H100 SXM outside the tensor cores (NVIDIA's
data sheet; the configuration runs float32 with TF32 off). The share of
the whole step: the records' seconds hold the fetch too. Nothing where
the program has no such counter."""

PEAK_FLOPS = 67e12


def read(run):
    pairs = sum(r.get("program", {}).get("counts", {})
                .get("eraft.pairs", 0) for r in run.records)
    if not pairs or run.seconds <= 0:
        return None
    ref = run.bench.reference(run.ctx.cfg["name"])
    flops = pairs * ref.flops_per_pair(run.ctx.cfg)
    return 100.0 * flops / run.seconds / PEAK_FLOPS
