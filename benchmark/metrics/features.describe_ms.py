"""features.describe_ms: median host milliseconds a frame of the program's
`features.describe` spans (slam.features: each level's IC angles and
descriptors, for mdBRIEF the dBRIEF pattern projection and the masks),
summed over the levels of one extraction, over the --trace 1 window's
frames; None where the program has no such span."""
import statistics


def read(run):
    v = run.spans.get("features.describe")
    return statistics.median(v) if v else None
