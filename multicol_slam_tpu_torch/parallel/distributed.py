"""Multi-process distributed bundle adjustment (port of
`multicol_slam_tpu/parallel/distributed.py`; BASELINE.md configuration 5).

One process per device, joined by `torch.distributed`: the observation
table shards over the ranks, the parameters replicate, and the LM / PCG
loop of optim/lm.py reduces its segment sums with `all_reduce` (its
reducer hook, the counterpart of the reference's `axis_name`). The
backend is NCCL when the rank's device is a card and gloo on the CPU; a
caller may name it (NCCL refuses two ranks on one card, so such a run
names gloo, which takes CUDA tensors too).

Cost model: per CG step each rank works on O(n_obs / n_ranks) rows; the
collectives move one packed buffer per Hessian-vector product, O(6K + 3P
+ 6C + 17C) floats (~0.7 MB at 64 keyframes / 50k points), and one scalar
for the cost; the point-sharded layout (parallel/ba.py) cuts the buffer to
O(6K + 23C).

Usage (one process per device):
    init_distributed(coordinator, n_procs, proc_id)   # tcp://host:port
    mesh = global_mesh()
    out, cost = multihost_bundle_adjust(params, obs_local, free, mesh)
Tested with gloo processes on the CPU (tests/test_torch_multihost.py,
tests/test_torch_parallel.py).
"""
from __future__ import annotations

import socket
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from multicol_slam_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from multicol_slam_tpu_torch.optim.lm import LMConfig, lm_solve
from multicol_slam_tpu_torch.optim.problem import BAParams, FreeMask, Observations, project_obs

AXIS = "obs"


class Mesh(NamedTuple):
    """The ranks of one process group along the reference's one mesh axis
    (AXIS), one device each (PyTorch's model): the group (None: the default
    group), this rank, the world size and this rank's device."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device


def _rank_device(device, rank: int) -> torch.device:
    """The rank's device: a card named without an index is card rank % count."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def free_address() -> str:
    """"127.0.0.1:<port>" with a port free on this host: an address for
    rank 0 of a group whose ranks all run here."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def init_distributed(coordinator_address: str, num_processes: int, process_id: int,
                     backend: Optional[str] = None, device=DEFAULT_DEVICE) -> None:
    """Join the process group (call once per process, before any collective).
    coordinator_address: "host:port" of rank 0 (or a "tcp://" URL). The
    rank's device becomes the current CUDA device; the backend defaults to
    NCCL on a card and gloo on the CPU."""
    dev = _rank_device(device, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id)


def global_mesh(device=DEFAULT_DEVICE) -> Mesh:
    """Every rank of the default group; this rank's device (for a card, the
    current CUDA device that init_distributed set)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(None, dist.get_rank(), dist.get_world_size(), dev)


def all_reduce_sum(mesh: Mesh):
    """The reducer of optim/lm.py over `mesh`: sums a tensor across its
    ranks in place."""
    def reduce(t: torch.Tensor) -> None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return reduce


def shard_rows_for_process(n_rows: int, mesh: Mesh) -> Tuple[int, int]:
    """(start, stop) of the observation rows this rank owns under an even
    split. n_rows must divide by the world size (pad with valid=False rows
    first: parallel.ba.pad_observations)."""
    if n_rows % mesh.size:
        raise ValueError(f"{n_rows} rows do not divide over {mesh.size} ranks: pad them first")
    per = n_rows // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def _on(tree, device):
    return type(tree)(*(x.to(device) if torch.is_tensor(x) else x for x in tree))


def multihost_bundle_adjust(params: BAParams, obs_local: Observations, free: FreeMask, mesh: Mesh,
                            config: LMConfig = LMConfig()) -> Tuple[BAParams, torch.Tensor]:
    """BA over the ranks of `mesh`. `obs_local` holds only this rank's row
    shard; params and free must be equal on every rank. Returns the
    parameters (equal on every rank) and the robust cost, on the rank's
    device. A world of one rank solves what `lm_solve` solves.

    The solve is `lm_solve` only: an interruptible solve (interrupt,
    pre_step) would let one rank decide alone and leave the others waiting
    in a collective."""
    params, obs_local, free = (_on(t, mesh.device) for t in (params, obs_local, free))
    return lm_solve(params, obs_local, free, config, reducer=all_reduce_sum(mesh))


# ---------------------------------------------------------------------------
# Large-map synthetic BA problem (the distributed benchmark workload)
# ---------------------------------------------------------------------------

def make_large_ba_problem(
    n_kfs: int = 64,
    n_points: int = 50_000,
    n_obs: int = 500_000,
    n_cams: int = 3,
    noise_px: float = 0.5,
    pose_noise: float = 0.01,
    point_noise: float = 0.05,
    seed: int = 0,
    device=DEFAULT_DEVICE,
):
    """Large-map BA instance (>= 64 keyframes / 50k points / 500k
    observations, BASELINE.md configuration 5): a corridor trajectory
    observing a point cloud through a 3-camera rig, with perturbed initial
    parameters. The host draws it with numpy in the reference's order, so a
    seed gives the reference's problem; the projection runs in float32 on
    the CPU, so a row on the image border may flip its `valid`. Returns
    (params_noisy, params_gt, obs, free) on `device`."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    intr = _make_intr(n_cams)
    mc = np.zeros((n_cams, 6), np.float32)
    mc[:, 3] = np.linspace(-0.15, 0.15, n_cams)
    poses = np.zeros((n_kfs, 6), np.float32)
    poses[:, 3] = np.linspace(0.0, 0.08 * n_kfs, n_kfs)          # corridor x
    poses[:, 1] = 0.02 * np.sin(np.linspace(0, 4 * np.pi, n_kfs))
    points = np.stack([
        rng.uniform(-1.0, 0.08 * n_kfs + 1.0, n_points),
        rng.normal(0.0, 1.5, n_points),
        rng.uniform(4.0, 10.0, n_points),
    ], -1).astype(np.float32)
    # observations biased to nearby keyframes: points near the keyframe's x
    kf = rng.integers(0, n_kfs, n_obs).astype(np.int32)
    px = poses[kf, 3]
    pt = np.clip(
        ((px[:, None] + rng.normal(0, 2.5, (n_obs, 1))) / (0.08 * n_kfs + 2.0)
         * n_points).astype(np.int64), 0, n_points - 1
    )[:, 0]
    order = np.argsort(points[:, 0], kind="stable")
    pt = order[pt].astype(np.int32)
    cam = rng.integers(0, n_cams, n_obs).astype(np.int32)
    t = torch.from_numpy
    with torch.no_grad():
        uv, z = project_obs(t(poses)[t(kf).long()], t(mc)[t(cam).long()], t(intr)[t(cam).long()],
                            t(points)[t(pt).long()])
    uv, z = uv.numpy(), z.numpy()
    keep = z > 0.5
    keep &= (uv[:, 0] > 5) & (uv[:, 0] < 250) & (uv[:, 1] > 5) & (uv[:, 1] < 186)
    uv = uv + rng.normal(0, noise_px, uv.shape)
    pose_d = np.concatenate([np.zeros((1, 6)), rng.normal(0, pose_noise, (n_kfs - 1, 6))]).astype(np.float32)
    point_d = rng.normal(0, point_noise, (n_points, 3)).astype(np.float32)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    gt = BAParams(on(poses), on(points), on(mc), on(intr))
    obs = Observations(on(kf), on(pt), on(cam), on(uv.astype(np.float32)), on(np.ones(n_obs, np.float32)), on(keep))
    noisy = BAParams(on(poses + pose_d), on(points + point_d), gt.mc, gt.intr)
    free = FreeMask(poses=on(np.array([False] + [True] * (n_kfs - 1))), points=on(np.ones(n_points, bool)))
    return noisy, gt, obs, free


def _make_intr(n_cams: int) -> np.ndarray:
    from multicol_slam_tpu_torch.models.camera import OmniCamera, fit_inverse_poly

    w, h = 256, 192
    pol = [-60.0, 0.0, 1.0 / 60.0, 0.0, 0.0]
    invpol = fit_inverse_poly(pol, rho_max=0.95 * (h / 2.0 + 22.0))
    cams = OmniCamera.from_params(
        [pol] * n_cams, [list(invpol)] * n_cams,
        [[1.0, 0.0, 0.0]] * n_cams,
        [[w / 2.0, h / 2.0]] * n_cams,
        [[w, h]] * n_cams,
        device="cpu",
    )
    return cams.to_vector().numpy()
