"""forward_ms.eraft: host ms a pair from the chunk's call into
``predict_pairs`` to its fields on the host (the driver's ``forward``
span), all forward time over all pairs."""


def read(run):
    pairs = sum(r["windows"] for r in run.records)
    spent = sum(r.get("spans", {}).get("forward", 0.0) for r in run.records)
    if not pairs or not spent:
        return None
    return spent / pairs * 1e3
