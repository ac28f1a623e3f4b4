"""k1.device_us: device microseconds a K1 launch (ops.best_match,
csrc/best_match.cu: the match kernel and its fill kernel) over the traced
frames: the profiler's device time of kernels named *best_match* or
prep_kernel, divided by the port's own launch counter over the same
frames."""


def read(run):
    if run.trace is None or not run.counters.get("k1_launches_traced"):
        return None
    s = sum(v for k, v in run.trace["device_s_by_name"].items() if "best_match" in k or "prep_kernel" in k)
    return s / run.counters["k1_launches_traced"] * 1e6 if s > 0 else None
