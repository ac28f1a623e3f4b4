"""Port parity: pose-only Gauss-Newton (`pose_only_solve`,
`pose_optimization`) and its residuals / closed-form Jacobian against the
JAX package (reverse-mode autodiff), on a synthetic observation table with
pixel noise and outliers. Poses agree within 1e-4, inlier masks exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.io.synthetic import make_synthetic_rig
from multicol_slam_tpu.optim import ba as jba
from multicol_slam_tpu.optim import lm as jlm
from multicol_slam_tpu.optim import problem as jprob
from multicol_slam_tpu.utils.geometry import cayley_to_hom
from multicol_slam_tpu_torch.optim import ba as tba
from multicol_slam_tpu_torch.optim import lm as tlm
from multicol_slam_tpu_torch.optim import problem as tprob

C, P = 3, 240
POSE_TRUE = np.array([0.05, -0.02, 0.03, 0.4, -0.1, 0.2], np.float32)
POSE_START = POSE_TRUE + np.array([0.004, -0.006, 0.003, 0.04, -0.03, 0.02], np.float32)


@pytest.fixture(scope="module")
def table():
    rig = make_synthetic_rig(n_cams=C, w=256, h=192)
    rng = np.random.default_rng(4)
    mc = np.asarray(rig.Mc_cayley, np.float32)
    intr = np.asarray(rig.cams.to_vector(), np.float32)
    cam = (np.arange(P) % C).astype(np.int32)
    # points in each camera's frame, in front (z > 0) and inside the fisheye's view
    Xc = np.stack([rng.uniform(-3, 3, P), rng.uniform(-3, 3, P), rng.uniform(2, 8, P)], -1)
    M = np.asarray(cayley_to_hom(jnp.asarray(POSE_TRUE))) @ np.asarray(cayley_to_hom(jnp.asarray(mc)))[cam]
    X = (np.einsum("pij,pj->pi", M[:, :3, :3], Xc) + M[:, :3, 3]).astype(np.float32)
    uv, z = jax.vmap(lambda c, x: jprob.project_obs(jnp.asarray(POSE_TRUE), jnp.asarray(mc)[c],
                                                    jnp.asarray(intr)[c], x))(jnp.asarray(cam), jnp.asarray(X))
    uv = np.asarray(uv) + rng.normal(0, 0.5, (P, 2))
    outlier = rng.uniform(size=P) < 0.1
    uv[outlier] += rng.uniform(15, 40, (outlier.sum(), 2))
    octave = rng.integers(0, 4, P)
    arrays = dict(
        poses=POSE_START[None], points=X, mc=mc, intr=intr,
        kf=np.zeros(P, np.int32), pt=np.arange(P, dtype=np.int32), cam=cam,
        uv=uv.astype(np.float32), inv_sigma2=(1.0 / 1.2 ** (2.0 * octave)).astype(np.float32),
        valid=rng.uniform(size=P) < 0.95,
    )
    assert (np.asarray(z) > 0).all()
    return arrays


def _jax(a):
    params = jprob.BAParams(*(jnp.asarray(a[k]) for k in ("poses", "points", "mc", "intr")))
    obs = jprob.Observations(*(jnp.asarray(a[k]) for k in ("kf", "pt", "cam", "uv", "inv_sigma2", "valid")))
    return params, obs


def _torch(a):
    params = tprob.BAParams(*(torch.tensor(a[k]) for k in ("poses", "points", "mc", "intr")))
    obs = tprob.Observations(
        *(torch.tensor(a[k]).long() for k in ("kf", "pt", "cam")),
        torch.tensor(a["uv"]), torch.tensor(a["inv_sigma2"]), torch.tensor(a["valid"]))
    return params, obs


def test_residuals_and_pose_jacobian(table):
    pj, oj = _jax(table)
    pt, ot = _torch(table)
    rj, zj, Jj = (np.asarray(x) for x in jax.jit(jprob.pose_residuals_and_jac)(pj, oj))
    rt, zt, Jt = tprob.pose_residuals_and_jac(pt, ot)
    np.testing.assert_allclose(rt.numpy(), rj, rtol=0, atol=2e-3)
    np.testing.assert_allclose(zt.numpy(), zj, rtol=1e-5, atol=1e-5)
    scale = np.abs(Jj).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(Jt.numpy() / scale, Jj / scale, rtol=0, atol=1e-4)
    r2, z2 = tprob.residuals_only(pt, ot)
    np.testing.assert_array_equal(r2.numpy(), rt.numpy())
    wj, cj = jprob.huber_weights(jnp.asarray(rj), jnp.asarray(zj), oj, 2.69)
    wt, ct = tprob.huber_weights(torch.tensor(rj), torch.tensor(zj), ot, 2.69)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6)
    np.testing.assert_allclose(float(tprob.robust_cost(torch.tensor(rj), torch.tensor(zj), ot, 2.69)),
                               float(jprob.robust_cost(jnp.asarray(rj), jnp.asarray(zj), oj, 2.69)), rtol=1e-5)


def test_pose_only_solve(table):
    pj, oj = _jax(table)
    pt, ot = _torch(table)
    out_j, chi2_j = jax.jit(jlm.pose_only_solve)(pj, oj)
    out_t, chi2_t = tlm.pose_only_solve(pt, ot)
    np.testing.assert_allclose(out_t.poses.numpy(), np.asarray(out_j.poses), rtol=0, atol=1e-4)
    # one robust round with 10 % outliers moves the start toward the truth
    assert np.linalg.norm(out_t.poses.numpy()[0] - POSE_TRUE) < np.linalg.norm(POSE_START - POSE_TRUE)
    fin = np.isfinite(np.asarray(chi2_j))
    np.testing.assert_array_equal(np.isfinite(chi2_t.numpy()), fin)
    np.testing.assert_allclose(chi2_t.numpy()[fin], np.asarray(chi2_j)[fin], rtol=1e-3, atol=1e-3)


def test_pose_optimization(table):
    pj, oj = _jax(table)
    pt, ot = _torch(table)
    poses_j, inl_j, n_j = jba.pose_optimization(pj, oj)
    poses_t, inl_t, n_t = tba.pose_optimization(pt, ot)
    np.testing.assert_allclose(poses_t.numpy(), np.asarray(poses_j), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(n_t) == int(n_j) and int(n_t) > 0.7 * P
    assert not inl_t.numpy()[~table["valid"]].any()
