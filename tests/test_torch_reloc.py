"""Relocalization's non-central absolute pose (`ops/ransac.py`) against the
JAX package. `ransac_noncentral_pose` fed JAX's own hypothesis indices
picks the same winner: the same inlier set and count, exactly. Its pose is
a 6-point DLT solved through float32 normal equations, which is
ill-conditioned: the two builds round the same minimal problem apart by up
to ~3e-2, so each side's pose is held to the true pose (5e-2). The refit
over all inliers (`refine_noncentral_pose`, what the system uses) agrees
between the two within 1e-3 and with the true pose within 1e-3. SVD signs
and orders may differ between the builds, so the tests hold the recovered
poses, not the raw matrices."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.ops import ransac as jransac
from multicol_slam_tpu_torch.ops import ransac as transac
from multicol_slam_tpu_torch.slam.map_store import cayley_to_hom_np

N_HYP = 160


def problem(seed, n=120, n_pad=8, outlier_frac=0.25):
    """Map points seen by a 3-camera rig at a known pose: unit rays in the
    observing camera's frame (a quarter replaced by random rays), and the
    reference's padding rows at the end (valid False)."""
    rng = np.random.default_rng(seed)
    Mc = np.stack([cayley_to_hom_np(np.array([0.0, 0.1 * c, 0.05 * c, 0.15 * np.cos(c), 0.15 * np.sin(c), 0.0]))
                   for c in range(3)])
    Mt = cayley_to_hom_np(np.array([0.02, -0.03, 0.1, 0.4, -0.2, 0.1]))
    cam = rng.integers(0, 3, n)
    Xc = rng.normal(size=(n, 3)) * [2.0, 2.0, 1.0] + [0, 0, 6.0]            # in front of each camera
    MtMc = Mt[None] @ Mc[cam]
    Xw = np.einsum("nij,nj->ni", MtMc[:, :3, :3], Xc) + MtMc[:, :3, 3]
    rays = Xc / np.linalg.norm(Xc, axis=-1, keepdims=True)
    bad = rng.uniform(size=n) < outlier_frac
    r = rng.normal(size=(bad.sum(), 3))
    rays[bad] = r / np.linalg.norm(r, axis=-1, keepdims=True)
    pad = lambda a, v=0.0: np.concatenate([a, np.full((n_pad,) + a.shape[1:], v)]).astype(np.float32)  # noqa: E731
    rays_p = pad(rays)
    rays_p[n:, 2] = 1.0
    arrays = dict(X=pad(Xw), rays=rays_p, Rc=pad(Mc[cam][:, :3, :3]), tc=pad(Mc[cam][:, :3, 3]),
                  valid=np.arange(n + n_pad) < n)
    return arrays, Mt, ~bad


def _jax(a):
    return {k: jnp.asarray(v) for k, v in a.items()}


def _torch(a):
    return {k: torch.tensor(v) for k, v in a.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_noncentral_pose_parity(seed):
    a, Mt_true, good = problem(seed)
    key = jax.random.fold_in(jax.random.PRNGKey(3), seed)
    w = a["valid"].astype(np.float32)
    idx = np.asarray(jransac.sample_indices(key, N_HYP, 6, len(w), weights=jnp.asarray(w / w.sum())))
    ref = jransac.ransac_noncentral_pose(key, **_jax(a), n_hyp=N_HYP)
    got = transac.ransac_noncentral_pose(**_torch(a), idx=torch.tensor(idx))
    assert int(got.n_inliers) == int(ref.n_inliers)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    n = int(a["valid"].sum())
    assert int(got.n_inliers) >= 0.9 * good.sum() and not got.inliers.numpy()[n:].any()
    np.testing.assert_allclose(got.Mt.numpy(), Mt_true, rtol=0, atol=5e-2)
    np.testing.assert_allclose(np.asarray(ref.Mt), Mt_true, rtol=0, atol=5e-2)


@pytest.mark.parametrize("seed", [0, 1])
def test_refine_noncentral_pose_parity(seed):
    a, Mt_true, good = problem(seed, n_pad=0)
    w = (good & a["valid"]).astype(np.float32)
    keys = ("X", "rays", "Rc", "tc")
    ref = np.asarray(jransac.refine_noncentral_pose(*(jnp.asarray(a[k]) for k in keys), jnp.asarray(w)))
    got = transac.refine_noncentral_pose(*(torch.tensor(a[k]) for k in keys), torch.tensor(w)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got, Mt_true, rtol=0, atol=1e-3)


def test_sampler_draws_distinct_valid_rows():
    valid = torch.tensor([True] * 10 + [False] * 6)
    idx = transac.sample_weighted(N_HYP, 6, valid, torch.Generator().manual_seed(0))
    assert idx.shape == (N_HYP, 6) and int(idx.max()) < 10
    assert all(len(set(row.tolist())) == 6 for row in idx)
