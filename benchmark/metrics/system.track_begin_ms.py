"""system.track_begin_ms: median host milliseconds of `track_begin` (the
system's host glue and the fused tracking program's dispatch), over the
window's frames that ran outside the profiler."""
import statistics


def read(run):
    v = run.spans.get("track_begin")
    return statistics.median(v) if v else None
