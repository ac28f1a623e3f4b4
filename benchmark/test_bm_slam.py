"""CPU tests of the SLAM cells' runner and output check: a short run of the
pipeline cell on the CPU at the configuration's full width (a few frames in
the window) comes out correct, and comes out not correct with the timed path
broken underneath: tracking that returns the predicted pose unchanged, an
extraction that leaves half of each camera's features out, a tracked pose
or a descriptor altered where it is produced; a local BA that returns its
state unchanged, that leaves half of its rows out, or whose poses are
altered where they are produced. There is no exchange between chips in
these one-card cells. ~1 min a run.

    python3 -m pytest benchmark/test_bm_slam.py -q
"""
from __future__ import annotations

import pytest
import torch

from benchmark import run as harness
from benchmark.runners.slam_stream import walk

SMALL = {"traffic": {"warm_frames": 10, "check_frames": 2, "check_local_ba": 1, "trace_frames": 1}}


def _run(workload="orb-pipeline", seconds=8.0, trace=False):
    torch.set_num_threads(4)
    return harness.run_cell(workload, 2 ** 31 + 29, seconds, trace, device="cpu", overrides=SMALL)


def test_walks():
    fwd = walk({}, 3)
    assert [next(fwd) for _ in range(6)] == [0, 1, 2, 3, 4, 5]
    bf = walk({"walk": "back_and_forth"}, 4)
    assert [next(bf) for _ in range(13)] == [0, 1, 2, 3, 2, 1, 0, 1, 2, 3, 2, 1, 0]


def test_pipeline_cell_runs_and_checks_on_the_cpu():
    line = _run(trace=True)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 2 and line["failed"] == 0
    assert {"system.track_begin_ms", "features.prepare_ms"} <= set(line["metrics"])
    assert list(line["checks"]) == ["kp_mismatch", "desc_mismatch", "pose_gap", "inlier_mismatch", "failed_share",
                                    "lba_cost_gap", "lba_cost_claim_gap", "lba_pose_gap"]
    assert line["checks"]["kp_mismatch"]["value"] == 0.0
    print(line["checks"])


def _fault(kind):
    from multicol_slam_tpu_torch.slam import system

    real_track, real_extract = system.track_frame_fused, system.extract_features

    def track(mc6, intr, cams, feats, pose_pred, *a, **kw):
        packed = real_track(mc6, intr, cams, feats, pose_pred, *a, **kw).clone()
        if kind == "unchanged":
            packed[7:13] = pose_pred
        elif kind == "pose_altered":
            packed[10] += 1e-2                       # a centimetre on x
        return packed

    def extract(images, cams, settings, tables=None, **kw):
        f = real_extract(images, cams, settings, tables, **kw)
        if kind == "half_features":
            f.valid[:, f.valid.shape[1] // 2:] = False
        elif kind == "desc_altered":
            f.desc[0, :, 0] ^= 1                     # a bit of every descriptor of camera 0
        return f
    return track, extract


def _ba_fault(kind):
    from multicol_slam_tpu_torch.optim import lm
    from multicol_slam_tpu_torch.slam import local_mapping

    real = local_mapping.bundle_adjust_interruptible

    def solve(params, obs, free, **kw):
        if kind == "ba_unchanged":
            real(params, obs, free, **kw)
            r, z = lm.residuals_only(params, obs)
            return params, lm.robust_cost(r, z, obs, lm.LMConfig().huber_delta)
        if kind == "ba_half_rows":
            keep = torch.arange(obs.valid.shape[0], device=obs.valid.device) % 2 == 0
            return real(params, obs._replace(valid=obs.valid & keep), free, **kw)
        out, cost = real(params, obs, free, **kw)
        return out._replace(poses=out.poses + 1e-2 * free.poses[:, None]), cost    # the answer altered
    return solve


@pytest.mark.parametrize("kind", ["unchanged", "half_features", "pose_altered", "desc_altered",
                                  "ba_unchanged", "ba_half_rows", "ba_altered"])
def test_pipeline_check_fails_on_a_broken_path(monkeypatch, kind):
    from multicol_slam_tpu_torch.slam import local_mapping, system

    if kind.startswith("ba_"):
        monkeypatch.setattr(local_mapping, "bundle_adjust_interruptible", _ba_fault(kind))
    else:
        track, extract = _fault(kind)
        monkeypatch.setattr(system, "track_frame_fused", track)
        monkeypatch.setattr(system, "extract_features", extract)
    line = _run()
    assert not line["correct"], (kind, line["checks"])
