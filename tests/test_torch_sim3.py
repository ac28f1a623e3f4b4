"""The port's Sim(3) geometry, Horn's Sim3 RANSAC, the Sim3 refinement and
the essential graph against the JAX package's, on the same numpy inputs.

Tolerances: the maps within 1e-6 absolute (2e-5 near pi, where the axis
comes from a square root of the diagonal); Horn's R within 1e-5 on
well-conditioned samples; the Sim3 RANSAC's winner within 2 inliers; the
solvers' outputs within 1e-4 (optimize_sim3, 12 Gauss-Newton steps) and
2e-5 absolute + 2e-5 relative (the essential graph, dense or PCG: float32
sums over 320 edges round apart), and both near the
ground truth as tests/test_optimizer.py asks of the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.ops import ransac as jr
from multicol_slam_tpu.optim import ba as jba
from multicol_slam_tpu.utils import geometry as jg
from multicol_slam_tpu_torch.ops import ransac as tr
from multicol_slam_tpu_torch.optim import ba as tba
from multicol_slam_tpu_torch.utils import geometry as tg

ANGLES = [0.0, 1e-8, 1e-4, 1e-2, 1.0, np.pi - 1e-3]


def _v7(theta, seed=0, sigma=0.1):
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    return np.concatenate([axis * theta, rng.normal(size=3), [sigma]]).astype(np.float32)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("theta", ANGLES)
def test_so3_maps(theta):
    w = _v7(theta)[:3]
    Rj, Rt = jg.so3_exp(jnp.asarray(w)), tg.so3_exp(torch.tensor(w))
    np.testing.assert_allclose(_np(Rt), _np(Rj), rtol=0, atol=1e-6)
    atol = 2e-5 if theta > 3.0 else 1e-6
    np.testing.assert_allclose(_np(tg.so3_log(Rt)), _np(jg.so3_log(Rj)), rtol=0, atol=atol)
    np.testing.assert_allclose(_np(tg.so3_log(Rt)), w, rtol=0, atol=2e-4 if theta > 3.0 else 1e-6)


@pytest.mark.parametrize("theta", ANGLES)
def test_sim3_maps(theta):
    v = _v7(theta, seed=1)
    Rj, tj, sj = jg.sim3_exp(jnp.asarray(v))
    Rt, tt, st = tg.sim3_exp(torch.tensor(v))
    for a, b in ((Rt, Rj), (tt, tj), (st, sj)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-6)
    lt, lj = tg.sim3_log(Rt, tt, st), jg.sim3_log(Rj, tj, sj)
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=0, atol=2e-5 if theta > 3.0 else 1e-6)


def test_sim3_group_ops_and_quaternions():
    rng = np.random.default_rng(2)
    v = np.stack([_v7(th, seed=i) for i, th in enumerate(ANGLES)])
    X = rng.normal(size=(len(v), 3)).astype(np.float32)
    a_j, b_j = jg.sim3_exp(jnp.asarray(v)), jg.sim3_exp(jnp.asarray(v[::-1].copy()))
    a_t, b_t = tg.sim3_exp(torch.tensor(v)), tg.sim3_exp(torch.tensor(v[::-1].copy()))
    pairs = [(tg.sim3_apply(*a_t, torch.tensor(X)), jg.sim3_apply(*a_j, jnp.asarray(X)))]
    pairs += list(zip(tg.sim3_inverse(*a_t), jg.sim3_inverse(*a_j)))
    pairs += list(zip(tg.sim3_compose(*a_t, *b_t), jg.sim3_compose(*a_j, *b_j)))
    q = rng.normal(size=(5, 4)).astype(np.float32)
    q[0] = 0.0
    pairs.append((tg.quat_to_rot(torch.tensor(q)), jg.quat_to_rot(jnp.asarray(q))))
    M = rng.normal(size=(2, 4, 4)).astype(np.float32)
    pairs.append((tg.hom_compose(torch.tensor(M[0]), torch.tensor(M[1])),
                  jg.hom_compose(jnp.asarray(M[0]), jnp.asarray(M[1]))))
    for a, b in pairs:
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-6)


def _point_sets(n=60, outliers=0.3, seed=3):
    """Q = s R P + t (rigid: s = 1) with noise and a share of outliers."""
    rng = np.random.default_rng(seed)
    P = rng.normal(size=(n, 3)).astype(np.float32) * 2.0 + np.array([0, 0, 5.0], np.float32)
    R, t, s = (np.asarray(a) for a in jg.sim3_exp(jnp.asarray(_v7(0.3, seed=seed, sigma=0.0))))
    Q = (s * P @ R.T + t + rng.normal(0, 0.005, (n, 3))).astype(np.float32)
    bad = rng.uniform(size=n) < outliers
    Q[bad] += rng.normal(0, 1.0, (int(bad.sum()), 3)).astype(np.float32)
    return P, Q, R


@pytest.mark.parametrize("with_scale", [False, True])
def test_horn_sim3(with_scale):
    P, Q, R = _point_sets(outliers=0.0)
    rng = np.random.default_rng(4)
    idx = np.stack([rng.choice(len(P), 3, replace=False) for _ in range(20)])
    Rj, tj, sj = jr.horn_sim3(jnp.asarray(P[idx]), jnp.asarray(Q[idx]), with_scale)
    Rt, tt, st = tr.horn_sim3(torch.tensor(P[idx]), torch.tensor(Q[idx]), with_scale)
    np.testing.assert_allclose(_np(Rt), _np(Rj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(tt), _np(tj), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_np(st), _np(sj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(Rt[0]), R, rtol=0, atol=1e-2)


def test_ransac_sim3_on_the_reference_draws():
    P, Q, R = _point_sets()
    key = jax.random.PRNGKey(7)
    idx = np.asarray(jr.sample_indices(key, 300, 3, len(P)))

    def err(xp):
        def fn(Rh, th, sh):
            X = sh[:, None, None] * xp.einsum("sij,nj->sni", Rh, xp.asarray(P) if xp is jnp else torch.tensor(P))
            d = (X + th[:, None, :]) - (xp.asarray(Q) if xp is jnp else torch.tensor(Q))
            return (d * d).sum(-1) < 0.05 ** 2
        return fn

    ref = jr.ransac_sim3(key, jnp.asarray(P), jnp.asarray(Q), jnp.ones(len(P), bool), err(jnp), n_hyp=300,
                         with_scale=False)
    got = tr.ransac_sim3(torch.tensor(P), torch.tensor(Q), torch.ones(len(P), dtype=torch.bool), err(torch),
                         with_scale=False, idx=torch.tensor(idx))
    assert abs(int(got.n_inliers) - int(ref.n_inliers)) <= 2 and int(ref.n_inliers) >= 30
    np.testing.assert_allclose(_np(got.R), _np(ref.R), rtol=0, atol=1e-4)
    gen = tr.ransac_sim3(torch.tensor(P), torch.tensor(Q), torch.ones(len(P), dtype=torch.bool), err(torch),
                         with_scale=False, generator=torch.Generator().manual_seed(0))
    assert abs(int(gen.n_inliers) - int(ref.n_inliers)) <= 2


def _sim3_problem():
    """tests/test_optimizer.py:176's problem (two keyframes, two cameras with
    its make_intr's intrinsics)."""
    from multicol_slam_tpu.models.camera import OmniCamera

    rng = np.random.default_rng(5)
    intr = OmniCamera.from_params([[-120.0, 0.0, 0.002, 0.0, 0.0]] * 2, [[115.0, 60.0, 5.0] + [0.0] * 9] * 2,
                                  [[1.0, 0.0, 0.0]] * 2, [[128.0, 96.0]] * 2, [[256, 192]] * 2).to_vector()
    mc = jnp.asarray(np.array([[0, 0, 0, -0.1, 0, 0], [0, 0, 0, 0.1, 0, 0]]), jnp.float32)
    N = 40
    X1 = jnp.asarray(rng.normal(size=(N, 3)) * 1.5 + np.array([0, 0, 5.0]), jnp.float32)
    v7_gt = jnp.asarray([0.02, -0.03, 0.01, 0.2, -0.1, 0.05, 0.1], jnp.float32)
    X2 = jg.sim3_apply(*jg.sim3_inverse(*jg.sim3_exp(v7_gt)), X1)
    cam1 = jnp.asarray(rng.integers(0, 2, N), jnp.int32)
    cam2 = jnp.asarray(rng.integers(0, 2, N), jnp.int32)
    uv1, z1 = jba._project_body(mc, intr, cam1, X1)
    uv2, z2 = jba._project_body(mc, intr, cam2, X2)
    sobs = jba.Sim3Obs(X1, X2, uv1, uv2, cam1, cam2, jnp.ones(N), jnp.ones(N), (z1 > 0) & (z2 > 0))
    v7_0 = v7_gt + jnp.asarray(rng.normal(0, 0.02, 7), jnp.float32)
    return sobs, mc, intr, v7_0, v7_gt


def test_project_body():
    sobs, mc, intr, _, _ = _sim3_problem()
    uv_j, z_j = jba._project_body(mc, intr, sobs.cam1, sobs.X1)
    uv_t, z_t = tba._project_body(torch.tensor(np.asarray(mc)), torch.tensor(np.asarray(intr)),
                                  torch.tensor(np.asarray(sobs.cam1)).long(), torch.tensor(np.asarray(sobs.X1)))
    np.testing.assert_allclose(_np(uv_t), _np(uv_j), rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(_np(z_t), _np(z_j), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3(fix_scale):
    sobs, mc, intr, v7_0, v7_gt = _sim3_problem()
    v_j, inl_j, n_j = jba.optimize_sim3(v7_0, sobs, mc, intr, n_iters=12, fix_scale=fix_scale)
    tobs = tba.Sim3Obs(*(torch.tensor(np.asarray(a)) for a in sobs))
    tobs = tobs._replace(cam1=tobs.cam1.long(), cam2=tobs.cam2.long())
    v_t, inl_t, n_t = tba.optimize_sim3(torch.tensor(np.asarray(v7_0)), tobs, torch.tensor(np.asarray(mc)),
                                        torch.tensor(np.asarray(intr)), n_iters=12, fix_scale=fix_scale)
    np.testing.assert_allclose(_np(v_t), _np(v_j), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(_np(inl_t), _np(inl_j))
    assert int(n_t) == int(n_j)
    if fix_scale:
        assert float(v_t[6]) == float(v7_0[6])
    else:
        np.testing.assert_allclose(_np(v_t), np.asarray(v7_gt), atol=2e-3)


def _chain(K, step, drift):
    """tests/test_optimizer.py:202 / :267's drifted chain with a loop edge."""
    v_gt = np.zeros((K, 7), np.float32)
    v_gt[:, 3] = -np.arange(K) * step
    v_est = v_gt.copy()
    v_est[:, 3] += np.cumsum(np.full(K, drift), 0)
    v_est[0] = v_gt[0]
    ei, ej = np.asarray(list(range(K - 1)) + [K - 1], np.int32), np.asarray(list(range(1, K)) + [0], np.int32)
    Si, Sj = jg.sim3_exp(jnp.asarray(v_gt[ei])), jg.sim3_exp(jnp.asarray(v_gt[ej]))
    meas = np.asarray(jg.sim3_log(*jg.sim3_compose(*Sj, *jg.sim3_inverse(*Si))))
    fixed = np.asarray([True] + [False] * (K - 1))
    return v_gt, v_est, ei, ej, meas, fixed


def test_edge_jacobians_match_jacfwd():
    rng = np.random.default_rng(6)
    vi, vj, m = (rng.normal(0, 0.3, (5, 7)).astype(np.float32) for _ in range(3))

    def res(a, b, c):
        Ri, ti, si = jg.sim3_exp(a)
        Rj, tj, sj = jg.sim3_exp(b)
        Rm, tm, sm = jg.sim3_exp(c)
        return jg.sim3_log(*jg.sim3_compose(*jg.sim3_compose(Rm, tm, sm, Ri, ti, si), *jg.sim3_inverse(Rj, tj, sj)))
    Ji = jax.vmap(jax.jacfwd(res, argnums=0))(vi, vj, m)
    Jj = jax.vmap(jax.jacfwd(res, argnums=1))(vi, vj, m)
    Ti, Tj = tba._edge_jacobians(torch.tensor(vi), torch.tensor(vj), torch.tensor(m))
    np.testing.assert_allclose(_np(Ti), np.asarray(Ji), rtol=0, atol=5e-5)
    np.testing.assert_allclose(_np(Tj), np.asarray(Jj), rtol=0, atol=5e-5)
    np.testing.assert_allclose(_np(tba._edge_residual(torch.tensor(vi), torch.tensor(vj), torch.tensor(m))),
                               np.asarray(jax.vmap(res)(vi, vj, m)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("K,step,drift,dense_limit,gt_tol", [(10, 1.0, 0.05, 300, 1e-2), (24, 0.5, 0.03, 300, 5e-3),
                                                             (24, 0.5, 0.03, 0, 5e-3), (320, 0.05, 0.002, 300, None),
                                                             (320, 0.05, 0.002, None, None)],
                         ids=["dense-K10", "dense-K24", "pcg-K24", "pcg-K320", "pcg-K320-default-limit"])
def test_optimize_essential_graph(K, step, drift, dense_limit, gt_tol):
    """Dense on :202's chain and :267's; PCG on :267's (dense_limit=0, as
    that test forces it) and on a chain of 320 keyframes, past the dense
    limit, where the branch is taken by size (also with dense_limit left at
    each package's default, None here). Near the ground truth as
    test_optimizer.py asks."""
    v_gt, v_est, ei, ej, meas, fixed = _chain(K, step, drift)
    n_iters = 30 if K < 300 else 8
    limit = {} if dense_limit is None else dict(dense_limit=dense_limit)
    je = jba.Sim3Edges(jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(meas), jnp.ones(K), jnp.ones(K, bool))
    ref = np.asarray(jba.optimize_essential_graph(jnp.asarray(v_est), je, jnp.asarray(fixed), n_iters=n_iters,
                                                  **limit))
    te = tba.Sim3Edges(torch.tensor(ei).long(), torch.tensor(ej).long(), torch.tensor(meas), torch.ones(K),
                       torch.ones(K, dtype=torch.bool))
    got = _np(tba.optimize_essential_graph(torch.tensor(v_est), te, torch.tensor(fixed), n_iters=n_iters,
                                           **limit))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    err = np.abs(got - v_gt).max()
    # 8 steps of 60 PCG iterations only start to undo the drift of 320
    # keyframes, in both packages
    assert err < gt_tol if gt_tol else err < 0.9 * np.abs(v_est - v_gt).max()


def test_loop_closer_eg_solve_takes_pcg_past_300():
    """LoopCloser._eg_solve (the system's dense-or-PCG choice on the padded
    K) on chip_smoke.py's problem of 320 keyframes, the chain above built
    in the port's geometry: both packages pad it to 512 and run PCG, and
    their poses agree within the essential graph's tolerance."""
    import chip_smoke as cs
    from multicol_slam_tpu.io.synthetic import make_synthetic_rig as jmake_rig
    from multicol_slam_tpu.slam import loop_closing as jlc
    from multicol_slam_tpu.slam import map_store as jms
    from multicol_slam_tpu_torch.io.synthetic import make_synthetic_rig
    from multicol_slam_tpu_torch.slam import loop_closing as tlc
    from multicol_slam_tpu_torch.slam import map_store as tms

    chain = cs.eg_chain(cs.EG_K)
    want = _chain(cs.EG_K, cs.EG_STEP, cs.EG_DRIFT)
    for a, b in zip(chain, want):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=0, atol=1e-6)
    prob = cs.eg_problem(chain)
    cfg = dict(max_keyframes=1, max_points=1, n_cams=3, feats_per_cam=1)
    ref = jlc.LoopCloser(jms.MapStore(jms.MapConfig(**cfg)), jmake_rig(3))._eg_solve(prob)["new_pose6"]
    branch = []
    orig = tlc.optimize_essential_graph

    def recorded(v, edges, fixed, **kw):
        branch.append((int(v.shape[0]), kw["dense_limit"]))
        return orig(v, edges, fixed, **kw)
    lc = tlc.LoopCloser(tms.MapStore(tms.MapConfig(**cfg)), make_synthetic_rig(3, device="cpu"))
    tlc.optimize_essential_graph = recorded
    try:
        got = lc._eg_solve(prob)["new_pose6"]
    finally:
        tlc.optimize_essential_graph = orig
    assert branch == [(cs.EG_K, 0)]
    np.testing.assert_allclose(got, ref, rtol=cs.EG_TOL, atol=cs.EG_TOL)
    # the loop edge pulls the chain's far end back toward its start
    assert np.abs(got - prob_pose6(prob)).max() > 1e-3


def prob_pose6(prob):
    """The problem's starting poses as the solve writes them (body -> world
    Cayley)."""
    from multicol_slam_tpu_torch.slam.map_store import hom_to_cayley_np

    out = []
    for R, t, s in zip(prob["vR"].astype(np.float64), prob["vt"].astype(np.float64), prob["vs"].astype(np.float64)):
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t / s
        out.append(hom_to_cayley_np(np.linalg.inv(T)))
    return np.asarray(out, np.float32)
