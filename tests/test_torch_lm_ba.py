"""The port's LM / PCG bundle adjustment against the JAX package's, on the
problems of tests/test_optimizer.py (K body poses on a line, P points in
front, 2 cameras; observations from the same projection model).

Tolerances: the port's Jacobians are closed-form and the reference's come
from jax.jacrev, both in float32, so blocks agree to 2e-6 of their largest
entry; sums over observations to 1e-5 relative, a 10-step PCG solve to
1e-3 relative; solved parameters to 1e-4 (poses, points) and 1e-5
(extrinsics) absolute. Chunking changes nothing (exact); padding changes
the order of the float32 sums only (1e-5 absolute on coordinates ~6 m)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.models.camera import OmniCamera as JCamera
from multicol_slam_tpu.optim import lm as jlm
from multicol_slam_tpu.optim.ba import bundle_adjust as jbundle_adjust
from multicol_slam_tpu.optim.ba import prune_observations as jprune
from multicol_slam_tpu.optim.problem import BAParams as JParams
from multicol_slam_tpu.optim.problem import FreeMask as JFree
from multicol_slam_tpu.optim.problem import Observations as JObs
from multicol_slam_tpu.optim.problem import project_obs
from multicol_slam_tpu.optim.problem import residuals_and_jacobians as jrj
from multicol_slam_tpu_torch.optim import lm
from multicol_slam_tpu_torch.optim.ba import bundle_adjust, bundle_adjust_interruptible, prune_observations
from multicol_slam_tpu_torch.optim.problem import BAParams, FreeMask, Observations, residuals_and_jacobians


def make_problem(K=5, P=60, C=2, seed=5, noise_px=0.0):
    """test_optimizer.make_world's problem: ground truth, then observations."""
    rng = np.random.default_rng(seed)
    intr = np.asarray(JCamera.from_params(
        [[-120.0, 0.0, 0.002, 0.0, 0.0]] * C, [[115.0, 60.0, 5.0] + [0.0] * 9] * C,
        [[1.0, 0.0, 0.0]] * C, [[128.0, 96.0]] * C, [[256, 192]] * C).to_vector())
    mc = np.zeros((C, 6), np.float32)
    mc[:, 3] = np.linspace(-0.1, 0.1, C)
    poses = np.zeros((K, 6), np.float32)
    poses[:, 3] = np.linspace(0, 1.0, K)
    poses[:, 0] = np.linspace(0, 0.05, K)
    points = (rng.normal(size=(P, 3)) * np.array([2.0, 1.5, 1.0]) + np.array([0.5, 0, 6.0])).astype(np.float32)
    kf, pt, cam = (a.ravel() for a in np.meshgrid(np.arange(K), np.arange(P), np.arange(C), indexing="ij"))
    gt = JParams(*(jnp.asarray(a) for a in (poses, points, mc, intr)))
    uv, z = jax.vmap(lambda k, p, c: project_obs(gt.poses[k], gt.mc[c], gt.intr[c], gt.points[p]))(kf, pt, cam)
    uv, z = np.asarray(uv), np.asarray(z)
    keep = (z > 0) & (uv[:, 0] > 5) & (uv[:, 0] < 250) & (uv[:, 1] > 5) & (uv[:, 1] < 186)
    uv = uv + rng.normal(0, noise_px, uv.shape) if noise_px else uv
    obs = dict(kf=kf.astype(np.int32), pt=pt.astype(np.int32), cam=cam.astype(np.int32),
               uv=uv.astype(np.float32), inv_sigma2=np.ones(len(kf), np.float32), valid=keep)
    return dict(poses=poses, points=points, mc=mc, intr=intr), obs, rng


def jax_side(params, obs):
    return (JParams(*(jnp.asarray(params[k]) for k in ("poses", "points", "mc", "intr"))),
            JObs(*(jnp.asarray(obs[k]) for k in ("kf", "pt", "cam", "uv", "inv_sigma2", "valid"))))


def torch_side(params, obs):
    return (BAParams(*(torch.tensor(params[k]) for k in ("poses", "points", "mc", "intr"))),
            Observations(*(torch.tensor(obs[k]) for k in ("kf", "pt", "cam", "uv", "inv_sigma2", "valid"))))


def perturbed(kind):
    """(params, obs, (jax free, torch free), solve_mc) of one BA mode."""
    if kind == "full":
        params, obs, rng = make_problem(K=5, P=60)
        params["poses"] = params["poses"] + np.concatenate([np.zeros((1, 6)), rng.normal(0, 0.02, (4, 6))]).astype(np.float32)
        params["points"] = params["points"] + rng.normal(0, 0.05, (60, 3)).astype(np.float32)
        fp, fx = np.array([False] + [True] * 4), np.ones(60, bool)
        return params, obs, (JFree(jnp.asarray(fp), jnp.asarray(fx)),
                             FreeMask(torch.tensor(fp), torch.tensor(fx))), False
    if kind == "structure_only":
        params, obs, rng = make_problem(K=4, P=50)
        params["points"] = params["points"] + rng.normal(0, 0.08, (50, 3)).astype(np.float32)
        fp, fx = np.zeros(4, bool), np.ones(50, bool)
        return params, obs, (JFree(jnp.asarray(fp), jnp.asarray(fx)),
                             FreeMask(torch.tensor(fp), torch.tensor(fx))), False
    params, obs, rng = make_problem(K=6, P=80)          # self-calibrating: the extrinsics free
    params["mc"] = params["mc"] + rng.normal(0, 0.005, params["mc"].shape).astype(np.float32)
    fp, fx = np.zeros(6, bool), np.zeros(80, bool)
    return params, obs, (JFree(jnp.asarray(fp), jnp.asarray(fx), mc=True),
                         FreeMask(torch.tensor(fp), torch.tensor(fx), mc=True)), True


def _close(a, b, rel):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * max(np.abs(a).max(), 1e-30))


@pytest.mark.parametrize("with_rig", [False, True], ids=["fixed_rig", "mc_and_intr"])
def test_residuals_and_jacobians(with_rig):
    params, obs, rng = make_problem(noise_px=0.5)
    params["poses"] = params["poses"] + rng.normal(0, 0.02, params["poses"].shape).astype(np.float32)
    jp, jo = jax_side(params, obs)
    tp, to = torch_side(params, obs)
    ref = jrj(jp, jo, with_mc=with_rig, with_intr=with_rig)
    got = residuals_and_jacobians(tp, to, with_mc=with_rig, with_intr=with_rig)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=1e-3)   # pixels
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-6, atol=1e-6)
    for name, a, b in zip(("pose", "point", "mc", "intr"), ref[2:], got[2:]):
        assert (a is None) == (b is None) == (name in ("mc", "intr") and not with_rig), name
        if a is not None:
            _close(np.moveaxis(np.asarray(a), -1, 0), b.numpy(), 2e-6)


def _linear_pieces(kind):
    params, obs, (jfree, tfree), solve_mc = perturbed(kind)
    jp, jo = jax_side(params, obs)
    tp, to = torch_side(params, obs)
    rj = jrj(jp, jo, with_mc=solve_mc, with_intr=False)
    rt = residuals_and_jacobians(tp, to, with_mc=solve_mc, with_intr=False)
    from multicol_slam_tpu.optim.problem import huber_weights as jhw
    from multicol_slam_tpu_torch.optim.problem import huber_weights as thw
    wj, _ = jhw(rj[0], rj[1], jo, 2.4477)
    wt, _ = thw(rt[0], rt[1], to, 2.4477)
    gj, bj = jlm._build_grad_and_blocks(jp, jo, rj[2], rj[3], rj[4], rj[5], wj, rj[0])
    seg = lm.make_segments(tp, to)
    gt, bt = lm._build_grad_and_blocks(tp, seg, rt[2], rt[3], rt[4], rt[5], wt, rt[0])
    return (jp, jo, jfree, rj, wj, gj, bj), (tp, to, tfree, seg, rt, wt, gt, bt)


@pytest.mark.parametrize("kind", ["full", "structure_only", "self_calibrating"])
def test_grad_blocks_hvp_pcg(kind):
    (jp, jo, jfree, rj, wj, gj, bj), (tp, to, tfree, seg, rt, wt, gt, bt) = _linear_pieces(kind)
    for a, b in zip(gj, gt):
        _close(a, b.numpy(), 1e-5)
    for a, b in zip(bj, bt):
        _close(a, b.numpy(), 1e-5)
    lam = 1e-3
    v = np.random.default_rng(3)
    vj = JParams(*(jnp.asarray(v.normal(size=x.shape).astype(np.float32)) for x in gj))
    vt = BAParams(*(torch.tensor(np.asarray(x)) for x in vj))
    hj = jlm._hvp(jo, rj[2], rj[3], rj[4], rj[5], wj, lam, bj, jfree, vj)
    ht = lm._hvp(to, seg, rt[2], rt[3], rt[4], rt[5], wt, torch.tensor(lam), bt, tfree, vt)
    for a, b in zip(hj, ht):
        _close(a, b.numpy(), 1e-5)
    Mj = tuple(jlm._block_inv(B, lam) for B in bj)
    Mt = tuple(lm._block_inv(B, torch.tensor(lam)) for B in bt)
    gj_m, gt_m = jlm._mask_params(gj, jfree), lm._mask_params(gt, tfree)
    xj = jlm._pcg(jo, rj[2], rj[3], rj[4], rj[5], wj, lam, bj, Mj, jfree, gj_m, 10)
    xt = lm._pcg(to, seg, rt[2], rt[3], rt[4], rt[5], wt, torch.tensor(lam), bt, Mt, tfree, gt_m, 10)
    for a, b in zip(xj, xt):     # 10 CG steps amplify the float32 rounding of either side
        _close(a, b.numpy(), 1e-3)


@pytest.mark.parametrize("kind", ["full", "structure_only", "self_calibrating"])
def test_bundle_adjust_matches_jax(kind):
    params, obs, (jfree, tfree), solve_mc = perturbed(kind)
    jp, jo = jax_side(params, obs)
    tp, to = torch_side(params, obs)
    iters = dict(full=(20, 30), structure_only=(15, 25), self_calibrating=(15, 30))[kind]
    oj, cj = jbundle_adjust(jp, jo, jfree, max_iters=iters[0], cg_iters=iters[1], solve_mc=solve_mc)
    ot, ct = bundle_adjust(tp, to, tfree, max_iters=iters[0], cg_iters=iters[1])
    np.testing.assert_allclose(ot.poses.numpy(), np.asarray(oj.poses), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ot.points.numpy(), np.asarray(oj.points), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ot.mc.numpy(), np.asarray(oj.mc), rtol=0, atol=1e-5)
    assert float(ct) <= max(1.5 * float(cj), 1e-6)
    gt_params, _, _ = make_problem(**dict(full=dict(K=5, P=60), structure_only=dict(K=4, P=50),
                                          self_calibrating=dict(K=6, P=80))[kind])
    key = dict(full="poses", structure_only="points", self_calibrating="mc")[kind]
    gate = dict(full=5e-3, structure_only=2e-2, self_calibrating=1e-3)[kind]
    assert np.abs(getattr(ot, key).numpy() - gt_params[key]).max() < gate   # test_optimizer.py's gates


def test_rig_blocks_follow_the_free_mask():
    """The rig's Jacobian blocks are built when `free` frees mc / intr, and
    only then: the self-calibrating problem moves the extrinsics (the same
    solve chunked or not), a per-camera mask moves only the cameras it
    frees, and with mc fixed nothing moves."""
    params, obs, (_, tfree), _ = perturbed("self_calibrating")
    tp, to = torch_side(params, obs)
    one, _ = bundle_adjust(tp, to, tfree, max_iters=6, cg_iters=10)
    chunked, _ = bundle_adjust_interruptible(tp, to, tfree, max_iters=6, cg_iters=10, chunk_iters=5)
    assert not torch.equal(one.mc, tp.mc)
    for a, b in zip(one, chunked):
        assert torch.equal(a, b)
    pinned, _ = bundle_adjust(tp, to, tfree._replace(mc=torch.tensor([False, True])), max_iters=6, cg_iters=10)
    assert torch.equal(pinned.mc[0], tp.mc[0]) and not torch.equal(pinned.mc[1], tp.mc[1])
    fixed, _ = bundle_adjust(tp, to, tfree._replace(mc=False), max_iters=6, cg_iters=10)
    for a, b in zip(fixed, tp):
        assert torch.equal(a, b)


def test_interruptible_equals_one_shot():
    """Chunks of 5 iterations with one read of `done` each give exactly the
    parameters of the loop that reads it after every iteration: iterations
    after `done` are no-ops."""
    params, obs, (_, tfree), _ = perturbed("full")
    tp, to = torch_side(params, obs)
    one, c1 = bundle_adjust(tp, to, tfree, max_iters=12, cg_iters=10)
    for chunk in (5, 12):
        chunked, c2 = bundle_adjust_interruptible(tp, to, tfree, max_iters=12, cg_iters=10, chunk_iters=chunk)
        for a, b in zip(one, chunked):
            assert torch.equal(a, b)
        assert torch.equal(c1, c2)
    calls = []
    first, _ = bundle_adjust_interruptible(tp, to, tfree, max_iters=12, cg_iters=10, chunk_iters=1,
                                           interrupt=lambda: calls.append(1) or True)
    assert len(calls) == 1 and not torch.equal(first.poses, one.poses)


def test_padded_equals_unpadded():
    """The reference pads BA problems to shape buckets (padding rows invalid,
    padding poses and points fixed); the port solves them at their size.
    Both give the same solution."""
    params, obs, (_, tfree), _ = perturbed("full")
    tp, to = torch_side(params, obs)
    K, P, O = tp.poses.shape[0], tp.points.shape[0], to.kf.shape[0]
    pK, pP, pO = 8, 256, 1024
    padp = BAParams(torch.cat([tp.poses, torch.zeros(pK - K, 6)]), torch.cat([tp.points, torch.zeros(pP - P, 3)]),
                    tp.mc, tp.intr)
    pad = pO - O
    pado = Observations(torch.cat([to.kf, torch.zeros(pad, dtype=to.kf.dtype)]),
                        torch.cat([to.pt, torch.full((pad,), pP - 1, dtype=to.pt.dtype)]),
                        torch.cat([to.cam, torch.zeros(pad, dtype=to.cam.dtype)]),
                        torch.cat([to.uv, torch.zeros(pad, 2)]), torch.cat([to.inv_sigma2, torch.zeros(pad)]),
                        torch.cat([to.valid, torch.zeros(pad, dtype=torch.bool)]))
    padf = FreeMask(torch.arange(pK) < K, torch.arange(pP) < P)
    padf = padf._replace(poses=padf.poses & torch.cat([tfree.poses, torch.zeros(pK - K, dtype=torch.bool)]))
    a, ca = bundle_adjust(tp, to, tfree, max_iters=12, cg_iters=20)
    b, cb = bundle_adjust(padp, pado, padf, max_iters=12, cg_iters=20)
    np.testing.assert_allclose(b.poses[:K].numpy(), a.poses.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(b.points[:P].numpy(), a.points.numpy(), rtol=0, atol=1e-5)
    assert torch.equal(b.poses[K:], padp.poses[K:]) and torch.equal(b.points[P:], padp.points[P:])
    assert abs(float(cb) - float(ca)) <= 1e-5 * float(ca) + 1e-9   # costs ~1e-8 px^2 at the optimum


def test_prune_observations():
    params, obs, _ = make_problem(K=2)
    obs["uv"] = obs["uv"].copy()
    obs["uv"][:10] += 50.0
    jp, jo = jax_side(params, obs)
    tp, to = torch_side(params, obs)
    got = prune_observations(tp, to).numpy()
    np.testing.assert_array_equal(got, np.asarray(jprune(jp, jo)))
    assert not got[:10].any() and got[10:][obs["valid"][10:]].all()
