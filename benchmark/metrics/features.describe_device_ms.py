"""features.describe_device_ms: median device milliseconds a frame of the
kernels whose innermost program range is `mcs.features.describe`
(benchmark/spans.reduce_by_span, one extraction's ranges at a time), over
the traced frames; None where the program has no such span."""
import statistics


def read(run):
    v = run.spans.get("features.describe_device")
    return statistics.median(v) if v else None
