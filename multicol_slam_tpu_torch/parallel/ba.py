"""Distributed bundle adjustment over the ranks of a process group (port of
`multicol_slam_tpu/parallel/ba.py`; BASELINE.md configuration 5).

The reference shards the observation table over a 1-D device mesh with
`shard_map`, and its LM / PCG loop psums every segment sum. Here each rank
is one process with one device (parallel/distributed.py): the table pads to
a multiple of the world size, each rank takes its contiguous row shard,
and optim/lm.py's reducer hook all-reduces the same sums (the gradient with
the block diagonals, each Hessian-vector product, the cost). The reduced
values are equal on every rank, so every rank steps the same LM
trajectory and returns the same parameters.

A second layout co-shards the points with the rows that observe them
(`point_sharded_bundle_adjust`): the point blocks never leave their rank
and only the pose and rig blocks and scalars are reduced.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from multicol_slam_tpu_torch.device import DEFAULT_DEVICE
from multicol_slam_tpu_torch.optim.lm import LMConfig, lm_solve
from multicol_slam_tpu_torch.optim.problem import BAParams, FreeMask, Observations
from multicol_slam_tpu_torch.parallel.distributed import (  # noqa: F401  (AXIS: the reference's name here)
    AXIS, Mesh, all_reduce_sum, global_mesh, multihost_bundle_adjust, shard_rows_for_process,
)


def make_mesh(n_devices: Optional[int] = None, device=DEFAULT_DEVICE) -> Mesh:
    """The mesh of every rank of the default group (one device a process).
    `n_devices`, when given, must be the world size."""
    mesh = global_mesh(device)
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"a mesh of {n_devices} devices asked for in a world of {mesh.size} ranks")
    return mesh


def pad_observations(obs: Observations, multiple: int) -> Observations:
    """Pad rows (valid=False, indices 0, uv and weight 0) so the table
    divides evenly across the ranks."""
    pad = (-obs.kf.shape[0]) % multiple
    if pad == 0:
        return obs
    return Observations(*(torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))]) for x in obs))


def distributed_bundle_adjust(params: BAParams, obs: Observations, free: FreeMask, mesh: Mesh,
                              config: LMConfig = LMConfig()) -> Tuple[BAParams, torch.Tensor]:
    """BA with the observation table sharded over the ranks of `mesh`. Every
    rank passes the whole table; it is padded to the world size, and this
    rank keeps its contiguous row shard: `multihost_bundle_adjust` after a
    local slice. Returns the parameters (equal on every rank) and the
    robust cost."""
    obs = pad_observations(obs, mesh.size)
    lo, hi = shard_rows_for_process(obs.kf.shape[0], mesh)
    return multihost_bundle_adjust(params, Observations(*(x[lo:hi] for x in obs)), free, mesh, config)


def point_sharded_bundle_adjust(params: BAParams, obs: Observations, free: FreeMask, mesh: Mesh,
                                config: LMConfig = LMConfig()) -> Tuple[BAParams, torch.Tensor]:
    """BA with the POINTS and their observation rows co-sharded over the
    ranks: each rank owns a contiguous block of points and exactly the rows
    that observe them, so the point-block reductions (V, g_pt, h_pt) stay
    on the rank and only the pose and rig blocks all-reduce (a buffer of
    O(6K + 23C) floats, whatever the map's size).

    Host prep (numpy, as the reference's): the points pad to a multiple of
    the world size; rows bucket by their owning rank (pt // per_rank), each
    bucket pads to the longest with valid=False rows; obs.pt becomes LOCAL
    indices. Every rank passes the whole problem. Returns the parameters
    with the GLOBAL point array (all_gather, cut to P) and the robust cost."""
    n = mesh.size
    P_n = params.points.shape[0]
    pad_p = (-P_n) % n
    per = (P_n + pad_p) // n
    points = torch.cat([params.points, params.points.new_zeros((pad_p, 3))])
    free_pts = torch.cat([free.points, free.points.new_zeros(pad_p)])

    # bucket the observation rows by the rank owning their point
    cols = {name: x.cpu().numpy() for name, x in zip(Observations._fields, obs)}
    owner = cols["pt"].astype(np.int64) // per
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=n)
    L = max(int(counts.max()) if len(counts) else 1, 1)
    start = int(counts[:mesh.rank].sum())
    rows = order[start:start + counts[mesh.rank]]
    local = {name: np.zeros((L,) + a.shape[1:], a.dtype) for name, a in cols.items()}
    for name, a in cols.items():
        local[name][:len(rows)] = a[rows]
    # local point indices; the padding rows are invalid and point at slot 0
    local["pt"][:len(rows)] -= mesh.rank * per
    local["valid"][len(rows):] = False
    dev = mesh.device
    obs_l = Observations(*(torch.from_numpy(local[name]).to(dev) for name in Observations._fields))
    blk = slice(mesh.rank * per, (mesh.rank + 1) * per)
    params_l = BAParams(params.poses.to(dev), points[blk].to(dev), params.mc.to(dev), params.intr.to(dev))
    free_l = FreeMask(free.poses.to(dev), free_pts[blk].to(dev),
                      *(m.to(dev) if torch.is_tensor(m) else m for m in (free.mc, free.intr)))
    out, cost = lm_solve(params_l, obs_l, free_l, config._replace(points_sharded=True),
                         reducer=all_reduce_sum(mesh))
    blocks = [torch.empty_like(out.points) for _ in range(n)]
    dist.all_gather(blocks, out.points.contiguous(), group=mesh.group)
    return out._replace(points=torch.cat(blocks)[:P_n]), cost
