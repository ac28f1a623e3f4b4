"""Both `MultiColSLAM`s with mdBRIEF's learned masks (use_mdbrief=1,
learn_masks=1: every matcher on the masked distance at x0.5 thresholds),
end to end on tests/test_slam_e2e.py's line world (2 cameras, 250 oracle
features a camera, 1 level, 30 frames). Each landmark has a seeded
stability mask that its features carry (`tests/torch_mdbrief_masks.py`);
the same numpy features go into both packages, and the port draws JAX's
RANSAC hypotheses (`tests/torch_jax_draws.py`).

Bounds: the same initialization frame; frames tracked within 1 of each
other and keyframes within 1; each ATE (Sim3-aligned, track-time poses)
below test_slam_e2e.py's 0.08 m and the port's within 1.25x the
reference's + 5 mm (tests/test_torch_system.py's bounds). The port's K1
calls (the plain version on the CPU) carry both masks at every caller:
the bootstrap, tracking, fusion, relocalization, and the async worker's.
"""
import sys
import threading

import numpy as np
import pytest
import torch

from multicol_slam_tpu.io.synthetic import make_world
from multicol_slam_tpu.slam import system as jsys
from multicol_slam_tpu.slam.features import FrameFeatures as JFeatures
from multicol_slam_tpu.slam.map_store import MapConfig as JMapConfig
from multicol_slam_tpu.slam.system import MultiColSLAM as JSLAM
from multicol_slam_tpu.utils.config import ExtractorSettings as JExtractor
from multicol_slam_tpu.utils.config import SlamSettings as JSettings
from multicol_slam_tpu_torch import convert
from multicol_slam_tpu_torch.io import trajectory as ttraj
from multicol_slam_tpu_torch.ops.best_match import masked_best_match_cams_plain
from multicol_slam_tpu_torch.slam import system as tsys
from multicol_slam_tpu_torch.slam.map_store import MapConfig
from multicol_slam_tpu_torch.slam.system import WORKING, MultiColSLAM
from multicol_slam_tpu_torch.utils.config import ExtractorSettings, SlamSettings
from multicol_slam_tpu_torch.utils.geometry import cayley_to_hom
from torch_jax_draws import JaxDraws
from torch_mdbrief_masks import landmark_masks, masked_fields

N_FEATS, N_FRAMES, SEED = 250, 30, 3
MAP = dict(max_keyframes=64, max_points=4000, n_cams=2, feats_per_cam=N_FEATS, n_levels=1, scale_factor=1.2)
# the callers of K1 in the system, by the function that calls them
CALLERS = {"_try_initialize": "bootstrap", "_track_frame_begin": "tracking", "_track_frame_finish": "tracking",
           "fuse_neighbors": "fusion", "_relocalize": "relocalization"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    return make_world(n_points=500, n_frames=N_FRAMES, n_cams=2, n_feats=N_FEATS, noise_px=0.2,
                      trajectory="line", seed=1)


@pytest.fixture(scope="module")
def frames(world):
    masks = landmark_masks(world, seed=5)
    return [masked_fields(world.frame_features(t), world, masks) for t in range(N_FRAMES)]


def _settings(pkg_extractor, pkg_settings):
    return pkg_settings(fps=25.0, extractor=pkg_extractor(n_features=N_FEATS, n_levels=1, use_mdbrief=1,
                                                          learn_masks=1))


def _rig(jrig):
    c = jrig.cams
    return convert.rig_from_numpy(*(np.asarray(getattr(c, k)) for k in ("pol", "invpol", "cde", "pp", "wh")),
                                  np.asarray(jrig.Mc_cayley), device="cpu")


def _jf(f):
    import jax.numpy as jnp

    return JFeatures(**{k: jnp.asarray(v) for k, v in f.items()})


def _tf(f):
    return convert.frame_features_from_numpy(**f, device="cpu")


class Recorder:
    """K1's plain version, recording for each call its caller, its thread
    and whether both masks came with it."""

    def __init__(self):
        self.calls = []

    def __call__(self, *a, **kw):
        f, caller = sys._getframe(1), None
        while f is not None and caller is None:
            caller = CALLERS.get(f.f_code.co_name)
            f = f.f_back
        self.calls.append((caller, threading.current_thread().name,
                           kw.get("mask_q") is not None and kw.get("mask_t") is not None))
        return masked_best_match_cams_plain(*a, **kw)


@pytest.fixture(scope="module")
def jax_run(world, frames):
    slam = JSLAM(world.rig, _settings(JExtractor, JSettings), JMapConfig(**MAP), use_loop_closing=False, seed=SEED)
    for t, f in enumerate(frames):
        slam.track(feats=_jf(f), timestamp=world.timestamps[t])
    return slam


@pytest.fixture(scope="module")
def port_run(world, frames, jax_run):
    draws = JaxDraws(SEED)
    rec = Recorder()
    slam = MultiColSLAM(_rig(world.rig), _settings(ExtractorSettings, SlamSettings), MapConfig(**MAP),
                        use_loop_closing=False, seed=SEED, device="cpu", init_sampler=draws.init,
                        reloc_sampler=draws.reloc, match_fn=rec)
    for t, f in enumerate(frames):
        slam.track(feats=_tf(f), timestamp=world.timestamps[t])
    return slam, rec


def _ate(world, slam):
    working = [m for m in slam.trajectory if m.state == WORKING]
    pos = lambda p: cayley_to_hom(torch.tensor(np.asarray(p, np.float32))).numpy()[:, :3, 3]  # noqa: E731
    est = pos(np.stack([m.pose for m in working]))
    gt = pos(world.poses[[m.frame_id for m in working]])
    return float(np.sqrt(np.mean(np.sum((ttraj.umeyama_align(est, gt) - gt) ** 2, -1))))


def test_masked_thresholds(jax_run, port_run):
    js, ts = jax_run, port_run[0]
    assert js.use_masks and ts.use_masks and ts.mapper.use_masks
    assert (ts.th_track, ts.th_low) == (js.th_track, js.th_low) == (48.0, 32.0)


def test_same_initialization_and_tracking(world, jax_run, port_run):
    js, ts = jax_run, port_run[0]
    first = lambda s: next(m.frame_id for m in s.trajectory if m.state == WORKING)  # noqa: E731
    tracked = lambda s: sum(m.state == WORKING for m in s.trajectory)  # noqa: E731
    assert first(ts) == first(js)
    assert tracked(js) >= 20 and abs(tracked(ts) - tracked(js)) <= 1, (tracked(ts), tracked(js))
    assert abs(int(ts.store.kf_valid.sum()) - int(js.store.kf_valid.sum())) <= 1
    ate_j, ate_t = _ate(world, js), _ate(world, ts)
    assert ate_j < 0.08 and ate_t < 0.08, (ate_t, ate_j)
    assert ate_t <= 1.25 * ate_j + 0.005, (ate_t, ate_j)
    # the points carry their first observation's stability mask
    pts = np.nonzero(ts.store.pt_valid)[0]
    assert (ts.store.pt_dmask[pts] < 255).any(axis=1).mean() > 0.9


def test_every_caller_matches_masked(port_run):
    calls = port_run[1].calls
    by_caller = {c: sum(1 for x in calls if x[0] == c) for c in set(CALLERS.values())}
    assert by_caller["bootstrap"] > 0 and by_caller["tracking"] > 0 and by_caller["fusion"] > 0, by_caller
    assert all(caller is not None for caller, _, _ in calls)
    assert all(masked for _, _, masked in calls)


def test_relocalization_masked(world, frames, jax_run, port_run):
    """`_relocalize` (no vocabulary: covisible candidates; the masked
    candidate matrix, then the masked radius-8 confirming stage) on frames 5
    and 25 against each finished map: both succeed, confirmed inliers
    within 10 % of each other. Runs after the tests above."""
    js, (ts, rec) = jax_run, port_run
    n_before = len(rec.calls)
    for t in (5, 25):
        mj = jsys.FrameMetrics(js.frame_id, 0.0, jsys.LOST, js.last_pose.copy())
        mt = tsys.FrameMetrics(ts.frame_id, 0.0, tsys.LOST, ts.last_pose.copy())
        assert js._relocalize(_jf(frames[t]), mj) and ts._relocalize(_tf(frames[t]), mt), t
        assert mj.n_inliers > 50 and abs(mt.n_inliers - mj.n_inliers) <= 0.1 * mj.n_inliers, (t, mt.n_inliers,
                                                                                               mj.n_inliers)
    new = rec.calls[n_before:]
    assert new and all(c == ("relocalization", "MainThread", True) for c in new), new


def test_masks_survive_reset_and_the_async_worker(world, frames):
    """Async mode: the tracker's launches are masked; a keyframe handed to
    the worker (this short run maps its first five inline) is mapped with
    the masked mapper, its fusion launches on the worker's thread carrying
    the masks; after reset() the new mapper and loop closer keep
    use_masks."""
    rec = Recorder()
    slam = MultiColSLAM(_rig(world.rig), _settings(ExtractorSettings, SlamSettings), MapConfig(**MAP),
                        async_mapping=True, seed=SEED, device="cpu", match_fn=rec)
    for t, f in enumerate(frames):
        slam.track(feats=_tf(f), timestamp=world.timestamps[t])
    slam._kf_queue.put(slam.last_kf_id)
    slam.wait_mapping_idle()
    assert slam.worker_errors == []
    on_worker = [c for c in rec.calls if c[1] == "mcslam-mapping"]
    assert on_worker and all(c[0] == "fusion" for c in on_worker), on_worker
    assert all(masked for _, _, masked in rec.calls)
    assert slam.loop_closer.use_masks and slam.mapper.use_masks
    slam.reset()
    assert slam.mapper.use_masks and slam.loop_closer.use_masks and slam.use_masks
    slam.shutdown()
