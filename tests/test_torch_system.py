"""The port's `MultiColSLAM` (sync mode) against the JAX package's, end to
end on tests/test_slam_e2e.py's line world (2 cameras, 250 oracle features
a camera, 1 level, 30 frames): the same numpy features go into both, and
the port's RANSAC draws JAX's own sample indices.

Bounds: both initialize on the same frame; frames tracked within 2 of each
other; keyframes within 1 and map points within 5 %; each ATE (Sim3-
aligned, track-time poses) below test_slam_e2e.py's 0.08 m, and the port's
within 1.25x the reference's + 5 mm. The trajectory helpers agree to 2e-6.
Last, a blackout frame sends both runs LOST, and both relocalize.

The system seed is 3. At seed 0 both still initialize on frame 2, but at
that 0.1 m baseline the 8-point fits of one camera score 148 inliers in the
JAX build and 156 in the port's from the same samples (float32 SVDs round
apart), so the two pick different leading cameras and end 8.6 % apart in
map points (233 / 255). Over seeds 1-6 the point counts end within
3.3 %.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.io import trajectory as jtraj
from multicol_slam_tpu.io.synthetic import make_world
from multicol_slam_tpu.slam.map_store import MapConfig as JMapConfig
from multicol_slam_tpu.slam.system import MultiColSLAM as JSLAM
from multicol_slam_tpu.utils.config import ExtractorSettings as JExtractor
from multicol_slam_tpu.utils.config import SlamSettings as JSettings
from multicol_slam_tpu_torch import convert
from multicol_slam_tpu_torch.io import trajectory as ttraj
from multicol_slam_tpu_torch.slam.map_store import MapConfig
from multicol_slam_tpu_torch.slam.system import WORKING, MultiColSLAM
from multicol_slam_tpu_torch.utils.config import ExtractorSettings, SlamSettings
from multicol_slam_tpu_torch.utils.geometry import cayley_to_hom
from torch_jax_draws import JaxDraws

N_FEATS, N_FRAMES, SEED = 250, 30, 3
FIELDS = ("uv", "response", "octave", "angle", "rays", "desc", "dmask", "valid")
MAP = dict(max_keyframes=64, max_points=4000, n_cams=2, feats_per_cam=N_FEATS, n_levels=1, scale_factor=1.2)


@pytest.fixture(scope="module")
def world():
    return make_world(n_points=500, n_frames=N_FRAMES, n_cams=2, n_feats=N_FEATS, noise_px=0.2,
                      trajectory="line", seed=1)


@pytest.fixture(scope="module")
def jax_run(world):
    slam = JSLAM(world.rig, JSettings(fps=25.0, extractor=JExtractor(n_features=N_FEATS, n_levels=1)),
                 JMapConfig(**MAP), use_loop_closing=False, seed=SEED)
    feats = [world.frame_features(t) for t in range(N_FRAMES)]
    for t in range(N_FRAMES):
        slam.track(feats=feats[t], timestamp=world.timestamps[t])
    return slam, feats


def _rig(jrig):
    c = jrig.cams
    return convert.rig_from_numpy(*(np.asarray(getattr(c, k)) for k in ("pol", "invpol", "cde", "pp", "wh")),
                                  np.asarray(jrig.Mc_cayley), device="cpu")


def _port_feats(f):
    return convert.frame_features_from_numpy(**{k: np.asarray(getattr(f, k)) for k in FIELDS}, device="cpu")


@pytest.fixture(scope="module")
def port_run(world, jax_run):
    draws = JaxDraws(SEED)
    slam = MultiColSLAM(_rig(world.rig), SlamSettings(fps=25.0, extractor=ExtractorSettings(n_features=N_FEATS,
                                                                                           n_levels=1)),
                        MapConfig(**MAP), use_loop_closing=False, seed=SEED, device="cpu",
                        init_sampler=draws.init, reloc_sampler=draws.reloc)
    for t, f in enumerate(jax_run[1]):
        slam.track(feats=_port_feats(f), timestamp=world.timestamps[t])
    return slam


def _ate(world, slam):
    working = [m for m in slam.trajectory if m.state == WORKING]
    pos = lambda p: cayley_to_hom(torch.tensor(np.asarray(p, np.float32))).numpy()[:, :3, 3]  # noqa: E731
    est = pos(np.stack([m.pose for m in working]))
    gt = pos(world.poses[[m.frame_id for m in working]])
    return float(np.sqrt(np.mean(np.sum((ttraj.umeyama_align(est, gt) - gt) ** 2, -1))))


def test_same_initialization_and_tracking(jax_run, port_run):
    js, ts = jax_run[0], port_run
    first = lambda s: next(m.frame_id for m in s.trajectory if m.state == WORKING)  # noqa: E731
    tracked = lambda s: sum(m.state == WORKING for m in s.trajectory)  # noqa: E731
    assert first(ts) == first(js)
    assert tracked(js) >= 15 and abs(tracked(ts) - tracked(js)) <= 2


def test_map_size(jax_run, port_run):
    js, ts = jax_run[0], port_run
    assert abs(int(ts.store.kf_valid.sum()) - int(js.store.kf_valid.sum())) <= 1
    nj, nt = int(js.store.pt_valid.sum()), int(ts.store.pt_valid.sum())
    assert nj >= 50 and abs(nt - nj) <= 0.05 * nj, (nt, nj)


def test_trajectory_accuracy(world, jax_run, port_run):
    ate_j, ate_t = _ate(world, jax_run[0]), _ate(world, port_run)
    assert ate_j < 0.08 and ate_t < 0.08, (ate_t, ate_j)
    assert ate_t <= 1.25 * ate_j + 0.005, (ate_t, ate_j)


def test_saved_trajectory_and_metrics(world, port_run, tmp_path):
    """save_trajectory writes the WORKING frames, keyframe-composed; its ATE
    by ate_rmse is as small; save_metrics writes a line a frame + a summary."""
    path = tmp_path / "traj.txt"
    port_run.save_trajectory(str(path))
    t_est, p_est = ttraj.load_tum_trajectory(str(path))
    assert len(t_est) == sum(m.state == WORKING for m in port_run.trajectory)
    gt = cayley_to_hom(torch.tensor(world.poses)).numpy()[:, :3, 3]
    assert ttraj.ate_rmse(t_est, p_est, world.timestamps, gt) < 0.08
    port_run.save_metrics(str(tmp_path / "metrics.jsonl"))
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == N_FRAMES + 1 and '"summary": true' in lines[-1]


def test_trajectory_helpers_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        pose = rng.normal(0, 0.5, 6).astype(np.float32)
        a = [float(x) for x in ttraj.pose_to_tum_line(1.5, pose).split()]
        b = [float(x) for x in jtraj.pose_to_tum_line(1.5, pose).split()]
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-6)
    t = np.arange(20) * 0.04
    p = rng.normal(size=(20, 3))
    q = 1.7 * p @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + 0.3 + rng.normal(0, 0.01, (20, 3))
    for align in (True, False):
        assert ttraj.ate_rmse(t, q, t, p, align=align) == pytest.approx(jtraj.ate_rmse(t, q, t, p, align=align),
                                                                         abs=1e-9)


def test_blackout_and_relocalization(world, jax_run, port_run):
    """The same frame of random features sends both finished systems LOST
    (their relocalization finds no candidate), and frame 25 again brings
    both back to WORKING (the tracker's wide-window retry). Then
    `_relocalize` itself (the branch without a vocabulary, the port drawing
    JAX's hypotheses) on frames 5 and 25 against each finished map: both
    succeed, with confirmed inliers within 10 % and poses within 2 cm and
    1e-2 (Cayley) of each other (the two DLT seeds round apart in float32,
    test_torch_reloc.py, and the confirming pose solve starts from them;
    at most 6.7 mm apart here). Runs after the tests above: it extends both
    runs by two frames."""
    from multicol_slam_tpu.slam import system as jsys
    from multicol_slam_tpu.slam.features import FrameFeatures as JFeatures
    from multicol_slam_tpu_torch.slam import system as tsys

    js, ts = jax_run[0], port_run
    rng = np.random.default_rng(0)
    C, K = 2, N_FEATS
    rays = rng.normal(size=(C, K, 3)).astype(np.float32)
    garbage = dict(uv=rng.uniform(10, 150, (C, K, 2)).astype(np.float32), response=np.ones((C, K), np.float32),
                   octave=np.zeros((C, K), np.int32), angle=np.zeros((C, K), np.float32),
                   rays=rays / np.linalg.norm(rays, axis=-1, keepdims=True),
                   desc=rng.integers(0, 256, (C, K, 32), dtype=np.uint8),
                   dmask=np.full((C, K, 32), 255, np.uint8), valid=np.ones((C, K), bool))
    js.track(feats=JFeatures(**{k: jnp.asarray(v) for k, v in garbage.items()}), timestamp=99.0)
    ts.track(feats=convert.frame_features_from_numpy(**garbage, device="cpu"), timestamp=99.0)
    assert js.state == jsys.LOST and ts.state == tsys.LOST
    f = jax_run[1][25]
    mj, mt = js.track(feats=f, timestamp=100.0), ts.track(feats=_port_feats(f), timestamp=100.0)
    assert mj.state == WORKING and mt.state == WORKING
    for t in (5, 25):
        f = jax_run[1][t]
        mj = jsys.FrameMetrics(js.frame_id, 0.0, jsys.LOST, js.last_pose.copy())
        mt = tsys.FrameMetrics(ts.frame_id, 0.0, tsys.LOST, ts.last_pose.copy())
        assert js._relocalize(f, mj) and ts._relocalize(_port_feats(f), mt), t
        assert ts._last_reloc_frame == ts.frame_id
        assert mj.n_inliers > 50 and abs(mt.n_inliers - mj.n_inliers) <= 0.1 * mj.n_inliers, (t, mt.n_inliers,
                                                                                               mj.n_inliers)
        np.testing.assert_allclose(ts.last_pose[3:], js.last_pose[3:], rtol=0, atol=2e-2)
        np.testing.assert_allclose(ts.last_pose[:3], js.last_pose[:3], rtol=0, atol=1e-2)


@pytest.mark.parametrize("kw", [dict(use_loop_closing=True, masks=True)], ids=["masks"])
def test_unported_modes_raise(world, kw):
    """mdBRIEF's learned masks construct (nothing raises): the x0.5
    thresholds, and use_masks on the mapper and the loop closer, before and
    after reset() (tests/test_torch_masked_system.py runs the mode)."""
    settings = SlamSettings(extractor=ExtractorSettings(use_mdbrief=1, learn_masks=1)) if kw.pop("masks", False) \
        else SlamSettings()
    slam = MultiColSLAM(_rig(world.rig), settings, device="cpu", **kw)
    for _ in range(2):
        assert slam.use_masks and (slam.th_track, slam.th_low) == (48.0, 32.0)
        assert slam.mapper.use_masks and slam.loop_closer.use_masks
        slam.reset()
    dbrief = MultiColSLAM(_rig(world.rig), SlamSettings(extractor=ExtractorSettings(use_mdbrief=1)), device="cpu")
    assert not dbrief.use_masks and (dbrief.th_track, dbrief.th_low) == (96.0, 64.0)
    assert not dbrief.mapper.use_masks and not dbrief.loop_closer.use_masks


def test_reference_of_another_bank_is_replaced(world, jax_run):
    """A reset with a runtime-bank frame in flight (the CLI's prefetch)
    makes that frame the reference of the next bootstrap while the next
    frames come with the init bank's 2x features: the first of those
    replaces the reference, and the bootstrap goes on from it."""
    from multicol_slam_tpu_torch.slam import system as tsys
    from multicol_slam_tpu_torch.slam.features import downselect_features

    slam = MultiColSLAM(_rig(world.rig), SlamSettings(fps=25.0, extractor=ExtractorSettings(n_features=N_FEATS,
                                                                                          n_levels=1)),
                        MapConfig(**MAP), use_loop_closing=False, seed=SEED, device="cpu")
    small, _ = downselect_features(_port_feats(jax_run[1][0]), N_FEATS // 2)
    slam.track(feats=small, timestamp=world.timestamps[0])
    assert slam.state == tsys.INITIALIZING and slam.ref_feats.valid.shape[1] == N_FEATS // 2
    full = _port_feats(jax_run[1][1])
    slam.track(feats=full, timestamp=world.timestamps[1])
    assert slam.state == tsys.INITIALIZING and slam.ref_feats is full
    for t in range(2, 8):
        slam.track(feats=_port_feats(jax_run[1][t]), timestamp=world.timestamps[t])
    assert slam.state == WORKING


@pytest.mark.parametrize("loops", [True, False], ids=["loops", "async"])
def test_async_mode_runs(world, jax_run, loops):
    """The async worker (test_torch_async.py holds it to the sync run): it
    starts, the system tracks a few frames and maps its first keyframes
    (inline, as the reference maps the first five), and shutdown joins the
    worker with no error on it."""
    slam = MultiColSLAM(_rig(world.rig), SlamSettings(fps=25.0, extractor=ExtractorSettings(n_features=N_FEATS,
                                                                                          n_levels=1)),
                        MapConfig(**MAP), use_loop_closing=loops, async_mapping=True, seed=SEED, device="cpu")
    worker = slam._worker
    assert worker.is_alive() and slam._map_stream is None   # the CPU: no stream
    for t, f in enumerate(jax_run[1][:8]):
        slam.track(feats=_port_feats(f), timestamp=world.timestamps[t])
    slam.wait_mapping_idle()
    slam.shutdown()
    assert not worker.is_alive() and slam._worker is None
    assert slam.worker_errors == []
    assert sum(m.state == WORKING for m in slam.trajectory) >= 5 and slam.store.kf_valid.sum() >= 2


def test_defaults_to_the_card(world):
    """The system runs on the card unless asked for the CPU; without one it
    raises instead of running on the CPU."""
    import inspect

    assert inspect.signature(MultiColSLAM).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MultiColSLAM(_rig(world.rig), SlamSettings(), use_loop_closing=False)
