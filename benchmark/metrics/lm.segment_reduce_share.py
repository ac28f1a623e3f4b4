"""lm.segment_reduce_share: percent of the traced solve's device time spent
in kernels named *segment_reduce* (optim.lm's deterministic segment sums)."""


def read(run):
    if run.trace is None:
        return None
    by = run.trace["device_s_by_name"]
    total = sum(by.values())
    seg = sum(v for k, v in by.items() if "segment_reduce" in k)
    return 100.0 * seg / total if total > 0 and seg > 0 else None
