"""The pose kernel's CPU side (`optim/ba.pose_optimization`): on CPU
tensors the dispatcher is exactly the plain version; the input check that
guards the kernel's pointers; the tracing counters; and the tag of the one
CUDA library, which must change with either source. The kernel itself runs
on the card only (tests/test_torch_pose_opt_cuda.py)."""
import shutil

import pytest
import torch

from multicol_slam_tpu_torch.ops import cuda_lib
from multicol_slam_tpu_torch.optim import ba
from multicol_slam_tpu_torch.utils import tracing
from torch_pose_problems import make_problem

# (seed, C, K, L, outlier share, invalid share, points behind, all invalid)
CASES = {
    "L50": (1, 3, 120, 50, 0.1, 0.05, 0, False),
    "behind_camera": (6, 3, 120, 300, 0.1, 0.05, 20, False),
    "all_invalid": (7, 3, 60, 300, 0.1, 0.05, 0, True),
    "one_camera": (8, 1, 150, 300, 0.1, 0.05, 0, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dispatch_on_cpu_is_the_plain_version(case):
    params, obs = make_problem(*CASES[case])
    got = ba.pose_optimization(params, obs)
    want = ba.pose_optimization_plain(params, obs)
    assert len(got) == 3
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _bad_inputs():
    params, obs = make_problem(2, 3, 20, 40)
    return {
        "uv_float64": (params, obs._replace(uv=obs.uv.double())),
        "pt_int32": (params, obs._replace(pt=obs.pt.int())),
        "valid_uint8": (params, obs._replace(valid=obs.valid.to(torch.uint8))),
        "uv_three_columns": (params, obs._replace(uv=torch.zeros(obs.uv.shape[0], 3))),
        "cam_short": (params, obs._replace(cam=obs.cam[:-1])),
        "intr_21": (params._replace(intr=params.intr[:, :21].contiguous()), obs),
        "uv_not_contiguous": (params, obs._replace(uv=obs.uv.t().contiguous().t())),
        "points_not_contiguous": (params._replace(points=params.points.t().contiguous().t()), obs),
        "two_poses": (params._replace(poses=params.poses.repeat(2, 1)), obs),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_input_check_rejects(case):
    params, obs = _bad_inputs()[case]
    with pytest.raises(ValueError):
        ba.check_pose_inputs(params, obs)
    with pytest.raises(ValueError):
        ba.pose_optimization(params, obs)


def test_input_check_accepts_a_tracking_problem():
    ba.check_pose_inputs(*make_problem(2, 3, 20, 40))


def _tracked_frame(dev="cpu"):
    """track_frame_fused on tests/test_torch_tracking.py's scene (3 cameras x
    128 features, 512 points), one step off frame 1's pose."""
    from multicol_slam_tpu_torch.io.synthetic import make_world
    from multicol_slam_tpu_torch.slam.tracking_kernels import LocalPoints, track_frame_fused

    L = 512
    world = make_world(n_points=L, n_frames=2, n_feats=128, seed=0)
    feats = world.frame_features(1, device=dev)
    pts = LocalPoints(X=torch.as_tensor(world.points, dtype=torch.float32, device=dev),
                      desc=torch.as_tensor(world.descs, device=dev),
                      min_dist=torch.full((L,), 5.0, device=dev), max_dist=torch.full((L,), 50.0, device=dev),
                      valid=torch.ones(L, dtype=torch.bool, device=dev))
    rig = world.rig
    step = torch.tensor([0.002, -0.003, 0.002, 0.02, -0.015, 0.01], device=dev)
    pose = torch.as_tensor(world.poses[1], dtype=torch.float32, device=dev) + step
    out = track_frame_fused(rig.Mc_cayley.to(dev, torch.float32), rig.cams.to_vector().to(dev), rig.cams.to(dev),
                            feats, pose, pts, pts, radius1=15.0, radius2=4.0)
    return feats, out


def test_span_counts_rows_on_cpu():
    """Each stage's `track.pose` span counts its rows and valid rows (set by
    the tracking stage); on the CPU there is no kernel, so no `iters`."""
    tracing.enable()
    try:
        feats, out = _tracked_frame()
        counts = [r.read_counts() for r in tracing.records() if r.name == "track.pose"]
    finally:
        tracing.disable()
        tracing.clear()
    rows = feats.desc.shape[0] * feats.desc.shape[1]
    assert len(counts) == 2 and int(out[14]) > 20
    assert all(set(c) == {"rows", "valid_rows"} and c["rows"] == rows and 0 < c["valid_rows"] <= rows
               for c in counts)


def test_off_adds_no_counters():
    """With the tracer off a tracked frame leaves no record, and on CPU
    tensors the iteration counts are None and the rest is the plain version."""
    _tracked_frame()
    assert tracing.records() == []
    params, obs = make_problem(*CASES["L50"])
    *got, iters = ba.pose_optimization_iters(params, obs)
    assert iters is None
    for a, b in zip(got, ba.pose_optimization_plain(params, obs)):
        assert torch.equal(a, b)


def test_library_tag_follows_every_source(tmp_path):
    srcs = [tmp_path / s.name for s in cuda_lib.SOURCES]
    assert len(srcs) == 2
    for s, src in zip(srcs, cuda_lib.SOURCES):
        shutil.copy(src, s)
    flags = cuda_lib.NVCC_FLAGS
    tag = cuda_lib.build_tag(srcs, flags)
    assert tag == cuda_lib.build_tag(cuda_lib.SOURCES, flags)
    assert cuda_lib.build_tag(srcs, flags[:-1]) != tag
    seen = {tag}
    for s in srcs:
        s.write_bytes(s.read_bytes() + b"\n// edited\n")
        seen.add(cuda_lib.build_tag(srcs, flags))
    assert len(seen) == 3
    assert cuda_lib.LIBRARY.path().name == f"libmcslam_kernels_{cuda_lib.build_tag(cuda_lib.SOURCES, flags)}.so"
