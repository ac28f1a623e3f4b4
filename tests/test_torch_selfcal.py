"""Self-calibrating BA: the port's `eval --selfcal` solve against the JAX
package's `bundle_adjust_jit(solve_mc=True)` on one small tracked problem.

The port tracks the first 24 frames of the eval's world (900 landmarks, a
3 m circle at 60 frames a lap, 250 oracle features, 0.15 px noise, seed 3)
and saves its map; the JAX package loads the file, so both build the BA
problem from the same store, and the problems must be equal. Cameras 1-2
are perturbed with the reference's draws (exactly the same values), freed
in one global BA (25 LM iterations, 40 PCG steps; camera 0 and the first
keyframe anchor the gauge), each package in float32 without the
reference's padding. Bounds: both reduce the extrinsic error 10x or more
(the reference's gate); the solved extrinsics agree to 2e-3 (Cayley and
metres: the two LMs take their steps in another order of float32 sums).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.io import checkpoint as jckpt
from multicol_slam_tpu.io.synthetic import make_world as jmake_world
from multicol_slam_tpu.optim.ba import bundle_adjust_jit
from multicol_slam_tpu.optim.problem import BAParams, FreeMask, Observations
from multicol_slam_tpu_torch import eval as teval
from multicol_slam_tpu_torch.io.synthetic import make_world
from multicol_slam_tpu_torch.slam.map_store import MapConfig
from multicol_slam_tpu_torch.slam.system import MultiColSLAM
from multicol_slam_tpu_torch.utils.config import ExtractorSettings, SlamSettings

N_TRACK, LAP = 24, 60
WORLD = dict(n_points=900, n_frames=LAP, n_cams=3, n_feats=250, noise_px=0.15, trajectory="circle_noyaw",
             radius=3.0, seed=3, period=LAP)


@pytest.fixture(scope="module")
def tracked(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        world = make_world(**WORLD)
        slam = MultiColSLAM(world.rig, SlamSettings(fps=10.0, extractor=ExtractorSettings(n_features=250, n_levels=1)),
                            MapConfig(max_keyframes=64, max_points=12000, n_cams=3, feats_per_cam=250, n_levels=1),
                            use_loop_closing=False, device="cpu")
        for t in range(N_TRACK):
            slam.track(feats=world.frame_features(t, device="cpu"), timestamp=world.timestamps[t])
    finally:
        torch.set_num_threads(n)
    path = str(tmp_path_factory.mktemp("selfcal") / "map.npz")
    slam.save_checkpoint(path)
    return world, slam, jckpt.load_map(path)


def test_same_problem(tracked):
    _, slam, jstore = tracked
    kfs = slam.store.active_kfs()
    assert len(kfs) >= 4
    a, b = slam.store.ba_problem(kfs[1:], kfs[:1]), jstore.ba_problem(kfs[1:], kfs[:1])
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_perturbation_is_the_reference_s():
    """The eval's perturbation: numpy draws of default_rng(5) on cameras 1..,
    as the root eval.py's _selfcal makes them."""
    mc = np.arange(18, dtype=np.float32).reshape(3, 6) / 10
    rng = np.random.default_rng(5)
    want = mc.copy()
    want[1:, :3] += rng.normal(0, 0.008, (2, 3)).astype(np.float32)
    want[1:, 3:] += rng.normal(0, 0.02, (2, 3)).astype(np.float32)
    np.testing.assert_array_equal(teval.perturb_extrinsics(mc), want)
    assert teval._mc_err(mc, mc) == pytest.approx(0.0, abs=1e-3)


def test_free_extrinsics_ba_matches_jax(tracked):
    world, slam, jstore = tracked
    jworld = jmake_world(**WORLD)
    mc_true = world.rig.Mc_cayley.numpy()
    np.testing.assert_array_equal(mc_true, np.asarray(jworld.rig.Mc_cayley))
    mc_pert = teval.perturb_extrinsics(mc_true)
    err0 = teval._mc_err(mc_pert, mc_true)

    mc_port, nK, nO = teval.selfcal_solve(slam, mc_pert)

    kfs = jstore.active_kfs()
    prob = jstore.ba_problem(kfs[1:], kfs[:1])
    params = BAParams(jnp.asarray(prob["poses"]), jnp.asarray(prob["points"]), jnp.asarray(mc_pert),
                      jnp.asarray(jworld.rig.cams.to_vector()))
    obs = Observations(jnp.asarray(prob["obs_kf"]), jnp.asarray(prob["obs_pt"]), jnp.asarray(prob["obs_cam"]),
                       jnp.asarray(prob["obs_uv"]), jnp.asarray(prob["obs_inv_sigma2"]),
                       jnp.ones(len(prob["obs_kf"]), bool))
    free = FreeMask(poses=jnp.asarray(np.arange(len(prob["kf_ids"])) < prob["n_free_kf"]),
                    points=jnp.ones(len(prob["pt_ids"]), bool), mc=jnp.asarray([False, True, True]))
    out, _ = bundle_adjust_jit(params, obs, free, max_iters=25, cg_iters=40, solve_mc=True)
    mc_jax = np.asarray(out.mc)

    assert (nK, nO) == (len(prob["kf_ids"]), len(prob["obs_kf"]))
    np.testing.assert_array_equal(mc_port[0], mc_pert[0])     # the gauge camera stays
    for mc in (mc_port, mc_jax):
        assert teval._mc_err(mc, mc_true) * 10.0 <= err0, (teval._mc_err(mc, mc_true), err0)
    np.testing.assert_allclose(mc_port, mc_jax, rtol=0, atol=2e-3)
