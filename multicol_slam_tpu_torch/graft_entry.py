"""The flagship step and the multi-device dry run (port of the repository's
`__graft_entry__.py`, which stays the JAX package's).

entry(device)        -> (fn, example_args): one tracking step, feature
                        extraction then one projection-guided matching and
                        pose-optimization stage (`track_stage`, one K1
                        launch), at 3 x 192x256 with 128 features x 4 levels.
dryrun_multichip(n)  -> one distributed-BA solve of a tiny problem (4 poses,
                        32 points, 2 cameras, 256 rows, 2 LM / 4 CG
                        iterations) over the ranks of the default process
                        group, both layouts held to the single-device solve.

Both run on the card unless the caller passes device="cpu".

    python3 -m multicol_slam_tpu_torch.graft_entry    # fn(*args) once, printed
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from multicol_slam_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from multicol_slam_tpu_torch.io.synthetic import make_synthetic_rig, make_world
from multicol_slam_tpu_torch.models.camera import OmniCamera
from multicol_slam_tpu_torch.optim.lm import LMConfig, _lm_cost, lm_solve
from multicol_slam_tpu_torch.optim.problem import BAParams, FreeMask, Observations, project_obs
from multicol_slam_tpu_torch.parallel.ba import distributed_bundle_adjust, make_mesh, point_sharded_bundle_adjust
from multicol_slam_tpu_torch.parallel.distributed import free_address, init_distributed
from multicol_slam_tpu_torch.slam.features import ExtractorTables, extract_features
from multicol_slam_tpu_torch.slam.tracking_kernels import LocalPoints, track_stage
from multicol_slam_tpu_torch.utils.config import ExtractorSettings

C, H, W = 3, 192, 256
L = 512
DRYRUN_TOL = 5e-3          # each layout's poses and points against the single-device solve


def flagship(device=DEFAULT_DEVICE):
    """The pieces of `entry`: (extract, track, example_args), where
    extract(images) -> FrameFeatures and track(feats, pose0) -> (pose,
    n_inliers). The reference's recipe: make_world(512 points, 2 frames, 3
    cameras, 128 features, seed 0), its first 512 landmarks as the local
    map, images from default_rng(0).uniform(0, 255), pose0 zeros."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    settings = ExtractorSettings(n_features=128, n_levels=4, scale_factor=1.2, fast_th=15)
    world = make_world(n_points=512, n_frames=2, n_cams=C, n_feats=128, seed=0)
    rig = make_synthetic_rig(C, device=device)     # world.rig, on the device
    mc6, intr = rig.Mc_cayley, rig.cams.to_vector()
    tables = ExtractorTables(settings, H, W, device=device)
    pts = LocalPoints(
        X=torch.tensor(world.points[:L].astype(np.float32), device=device),
        desc=torch.tensor(world.descs[:L], device=device),
        min_dist=torch.full((L,), 0.5, device=device),
        max_dist=torch.full((L,), 25.0, device=device),
        valid=torch.ones(L, dtype=torch.bool, device=device),
    )

    def extract(images):
        return extract_features(images, rig.cams, settings, tables)

    def track(feats, pose0):
        out = track_stage(mc6, intr, rig.cams, feats, pose0, pts, scale_factor=1.2, n_levels=4, radius=15.0,
                          th_desc=96.0)
        return out.pose, out.n_inliers

    images = torch.tensor(rng.uniform(0, 255, (C, H, W)).astype(np.float32), device=device)
    pose0 = torch.zeros(6, dtype=torch.float32, device=device)
    return extract, track, (images, pose0)


def entry(device=DEFAULT_DEVICE):
    """(fn, example_args): fn(images, pose0) -> (pose, n_inliers), the
    flagship step of the SLAM engine."""
    extract, track, args = flagship(device)

    def fn(images, pose0):
        return track(extract(images), pose0)
    return fn, args


def dryrun_problem(device=DEFAULT_DEVICE):
    """The dry run's problem, projected by the port: (noisy params, obs,
    free, config) on `device`."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    K, P, Cc = 4, 32, 2
    cams = OmniCamera.from_params([[-120.0, 0.0, 0.002, 0.0, 0.0]] * Cc, [[115.0, 60.0, 5.0] + [0.0] * 9] * Cc,
                                  [[1.0, 0.0, 0.0]] * Cc, [[128.0, 96.0]] * Cc, [[256, 192]] * Cc, device="cpu")
    poses = np.zeros((K, 6), np.float32)
    poses[:, 3] = np.linspace(0, 0.5, K)
    points = (rng.normal(size=(P, 3)) * 1.5 + np.array([0, 0, 6.0])).astype(np.float32)
    mc = np.zeros((Cc, 6), np.float32)
    mc[:, 3] = [-0.1, 0.1]
    params = BAParams(torch.from_numpy(poses), torch.from_numpy(points), torch.from_numpy(mc), cams.to_vector())
    kf, pt, cam = (torch.from_numpy(a.ravel()) for a in np.meshgrid(np.arange(K), np.arange(P), np.arange(Cc),
                                                                     indexing="ij"))
    uv, z = project_obs(params.poses[kf], params.mc[cam], params.intr[cam], params.points[pt])
    obs = Observations(kf.int(), pt.int(), cam.int(), uv, torch.ones(len(kf)), z > 0)
    free = FreeMask(torch.tensor([False] + [True] * (K - 1)), torch.ones(P, dtype=torch.bool))
    noisy = params._replace(points=params.points + 0.02)
    return tuple(type(t)(*(x.to(device) if torch.is_tensor(x) else x for x in t)) for t in (noisy, obs, free)) + (
        LMConfig(max_iters=2, cg_iters=4),)


def dryrun_multichip(n_devices: int, device=DEFAULT_DEVICE) -> dict:
    """One distributed-BA solve of the dry run's problem over the ranks of
    the default process group, in both layouts (`rows`: the observation
    table sharded, `points`: points co-sharded with their rows), and the
    single-device `lm_solve` on each rank. Asserts what the reference
    asserts: the costs finite and below half the start, each layout's poses
    and points within 5e-3 of the single solve's. `n_devices` must be the
    world size; with no group and n_devices == 1 a group of one rank is
    opened here (and closed). Returns {"cost0": float, layout: (params,
    cost) for "rows", "points", "single"}."""
    own = not dist.is_initialized()
    if own:
        if n_devices != 1:
            raise ValueError(f"no process group: a dry run of {n_devices} devices needs one of {n_devices} ranks")
        init_distributed(free_address(), 1, 0, device=device)
    try:
        mesh = make_mesh(n_devices, device=device)
        noisy, obs, free, cfg = dryrun_problem(mesh.device)
        cost0 = float(_lm_cost(noisy, obs, cfg))
        out = {"cost0": cost0, "rows": distributed_bundle_adjust(noisy, obs, free, mesh, cfg),
               "points": point_sharded_bundle_adjust(noisy, obs, free, mesh, cfg),
               "single": lm_solve(noisy, obs, free, cfg)}
    finally:
        if own:
            dist.destroy_process_group()
    single = out["single"][0]
    for layout in ("rows", "points"):
        params, cost = out[layout]
        if not np.isfinite(float(cost)):
            raise AssertionError(f"distributed BA ({layout}) produced a non-finite cost")
        if not float(cost) < 0.5 * cost0:
            raise AssertionError(f"distributed BA ({layout}) did not reduce the cost: {cost0} -> {float(cost)}")
        for key in ("poses", "points"):
            err = float((getattr(params, key) - getattr(single, key)).abs().max())
            if not err <= DRYRUN_TOL:
                raise AssertionError(f"distributed BA ({layout}) {key} {err} from the single solve "
                                     f"(tolerance {DRYRUN_TOL})")
    return out


if __name__ == "__main__":
    fn, args = entry()
    print(fn(*args))
