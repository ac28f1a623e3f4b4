"""features.prepare_ms: median host milliseconds of `prepare` (the
extraction's dispatch, slam.features), over the window's frames that ran
outside the profiler."""
import statistics


def read(run):
    v = run.spans.get("prepare")
    return statistics.median(v) if v else None
