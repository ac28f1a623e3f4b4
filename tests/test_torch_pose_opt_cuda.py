"""The pose kernel (`optim/ba.pose_optimization` on CUDA tensors,
csrc/pose_opt.cu: both robust rounds of tracking's pose-only Gauss-Newton
in one launch) against its plain PyTorch version, on the card.

Imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_pose_opt_cuda.py -q --noconftest

Every case skips where there is no CUDA device. The tolerances, and why,
are torch_pose_problems.POSE_TOL, GATE_BAND and HARD_POSE_TOL's note; besides,
n_inliers equals the sum of the kernel's own mask exactly, and two
launches on the same inputs are bitwise equal (no float atomics)."""
import functools

import pytest
import torch

from multicol_slam_tpu_torch.optim import ba
from torch_pose_problems import (
    HARD_POSE_TOL, MIN_TRACK_INLIERS, behind_rows, compare, hard_problems, make_problem, to_device,
)

# (seed, C, K, L, outlier share, invalid share, points behind, all invalid)
CASES = {
    "L50": (1, 3, 400, 50, 0.1, 0.05, 0, False),
    "L1500": (2, 3, 400, 1500, 0.1, 0.05, 0, False),
    "L4096": (3, 3, 400, 4096, 0.1, 0.05, 0, False),
    "outliers_30pct": (4, 3, 400, 1500, 0.3, 0.05, 0, False),
    "invalid_40pct": (5, 3, 400, 1500, 0.1, 0.4, 0, False),
    "behind_camera": (6, 3, 400, 1500, 0.1, 0.05, 60, False),
    "all_invalid": (7, 3, 400, 1500, 0.1, 0.05, 0, True),
    "one_camera": (8, 1, 400, 1500, 0.1, 0.05, 0, False),
    "ragged_O": (9, 3, 377, 1500, 0.1, 0.05, 0, False),
    # 6,000 rows do not fit in shared memory: the rows live in device scratch
    "rows_in_device_memory": (10, 3, 2000, 4096, 0.1, 0.05, 0, False),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernel)")
    return torch.device("cuda", 0)


def _problem(case, dev):
    seed, C, K, L, out, inv, back, none = CASES[case]
    params, obs = make_problem(seed, C, K, L, out, inv, back, none)
    if back:
        assert behind_rows(params, obs).sum() > 0
    return to_device(params, obs, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain(case):
    dev = _card()
    params, obs = _problem(case, dev)
    before = ba.POSE_KERNEL.launches
    pose, inl, n = ba.pose_optimization(params, obs)
    pose_p, inl_p, n_p = ba.pose_optimization_plain(params, obs)
    torch.cuda.synchronize()
    assert ba.POSE_KERNEL.launches == before + 1
    assert pose.shape == (1, 6) and inl.dtype == torch.bool and n.dtype == torch.int64
    cmp = compare(params, obs, (pose, inl, n), (pose_p, inl_p, n_p))
    assert cmp["ok"], cmp
    if CASES[case][-1]:
        assert int(n) == 0 and torch.equal(pose, params.poses)
    else:
        assert int(n) > 0.5 * int(obs.valid.sum())
    if CASES[case][6]:
        assert not inl[behind_rows(params, obs)].any()


N_HARD = 40
_hard_problems = functools.lru_cache(maxsize=1)(hard_problems)


@pytest.mark.cuda
@pytest.mark.parametrize("i", range(N_HARD))
def test_kernel_matches_plain_on_hard_problems(i):
    """The stress sequence's problems: inlier counts always equal; where
    tracking would keep the pose (the plain version keeps >= 15 inliers),
    the pose within HARD_POSE_TOL and the inlier flags equal outside the
    gate band."""
    dev = _card()
    params, obs, what = _hard_problems(N_HARD)[i]
    params, obs = to_device(params, obs, dev)
    got = ba.pose_optimization(params, obs)
    plain = ba.pose_optimization_plain(params, obs)
    assert int(got[2]) == int(plain[2]), what
    cmp = compare(params, obs, got, plain, pose_tol=HARD_POSE_TOL)
    assert cmp["n_is_mask_sum"] and not cmp["invalid_in"], (what, cmp)
    if int(plain[2]) >= MIN_TRACK_INLIERS:
        assert cmp["ok"], (what, cmp)


@pytest.mark.cuda
def test_two_launches_are_bitwise_equal():
    dev = _card()
    params, obs = _problem("L1500", dev)
    before = ba.POSE_KERNEL.launches
    a = ba.pose_optimization_cuda(params, obs)
    b = ba.pose_optimization_cuda(params, obs)
    torch.cuda.synchronize()
    assert ba.POSE_KERNEL.launches == before + 2
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert 1 <= int(a[3][0]) <= ba.POSE_ITERS and 1 <= int(a[3][1]) <= ba.POSE_ITERS


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs():
    dev = _card()
    params, obs = _problem("ragged_O", dev)
    with pytest.raises(ValueError):
        ba.pose_optimization(params, obs._replace(uv=obs.uv.double()))
    with pytest.raises(ValueError):
        ba.pose_optimization(params, obs._replace(valid=obs.valid.cpu()))
    with pytest.raises(ValueError):
        ba.pose_optimization(params._replace(poses=params.poses.repeat(2, 1)), obs)


@pytest.mark.cuda
def test_tracked_frame_launches_the_kernel_once_a_stage():
    """track_frame_fused on the card: one launch a stage, two a frame, and
    the `track.pose` spans' counters (iters read from the kernel)."""
    from multicol_slam_tpu_torch.io.synthetic import make_world
    from multicol_slam_tpu_torch.slam.tracking_kernels import LocalPoints, track_frame_fused
    from multicol_slam_tpu_torch.utils import tracing

    dev = _card()
    L = 512   # tests/test_torch_tracking.py's scene, which tracks
    world = make_world(n_points=L, n_frames=2, n_feats=128, seed=0)
    feats = world.frame_features(1, device=dev)
    pts = LocalPoints(X=torch.as_tensor(world.points, dtype=torch.float32, device=dev),
                      desc=torch.as_tensor(world.descs, device=dev),
                      min_dist=torch.full((L,), 5.0, device=dev), max_dist=torch.full((L,), 50.0, device=dev),
                      valid=torch.ones(L, dtype=torch.bool, device=dev))
    rig = world.rig
    step = torch.tensor([0.002, -0.003, 0.002, 0.02, -0.015, 0.01], device=dev)
    pose = torch.as_tensor(world.poses[1], dtype=torch.float32, device=dev) + step
    before = ba.POSE_KERNEL.launches
    tracing.enable()
    try:
        out = track_frame_fused(rig.Mc_cayley.to(dev, torch.float32), rig.cams.to_vector().to(dev),
                                rig.cams.to(dev), feats, pose, pts, pts, radius1=15.0, radius2=4.0)
        torch.cuda.synchronize()
        counts = [r.read_counts() for r in tracing.records() if r.name == "track.pose"]
    finally:
        tracing.disable()
        tracing.clear()
    assert ba.POSE_KERNEL.launches == before + 2
    assert len(counts) == 2 and all(c["rows"] == feats.desc.shape[0] * feats.desc.shape[1] for c in counts)
    assert all(0 < c["valid_rows"] <= c["rows"] and 2 <= c["iters"] <= 2 * ba.POSE_ITERS for c in counts)
    assert int(out[14]) > 20
