"""Resume and localization mode: the port's `MultiColSLAM.resume` and
`activate_localization_mode` against the JAX package's, on
tests/test_slam_e2e.py's line world (2 cameras, 250 oracle features a
camera, 1 level; system seed 3, as tests/test_torch_system.py).

The JAX system maps frames 0-29 and saves its map. Each package loads the
file with its own `load_map` and resumes from it as its CLI's --load-map
does (state LOST, the map exempt from the auto-reset), in localization
mode, and tracks frames 20-29 again, the port drawing JAX's relocalization
hypotheses (tests/torch_jax_draws.py). Bounds: the same state and the same
inlier count on every frame; positions within 2 cm and Cayley rotations
within 1e-2 (the relocalization's DLT seeds round apart in float32,
tests/test_torch_system.py); the map's keyframes and points exactly as
loaded in both.

Then the port alone: a map of <= 3 keyframes survives a lost frame once
resumed (and is reset without the flag), `deactivate_localization_mode`
lets keyframe insertion resume, and `save_checkpoint` writes the store.
"""
import numpy as np
import pytest
import torch

from multicol_slam_tpu.io import checkpoint as jckpt
from multicol_slam_tpu.io.synthetic import make_world
from multicol_slam_tpu.slam.local_mapping import LocalMapper as JLocalMapper
from multicol_slam_tpu.slam.map_store import MapConfig as JMapConfig
from multicol_slam_tpu.slam.system import LOST as JLOST
from multicol_slam_tpu.slam.system import MultiColSLAM as JSLAM
from multicol_slam_tpu.utils.config import ExtractorSettings as JExtractor
from multicol_slam_tpu.utils.config import SlamSettings as JSettings
from multicol_slam_tpu_torch import convert
from multicol_slam_tpu_torch.io import checkpoint as tckpt
from multicol_slam_tpu_torch.slam.map_store import MapConfig
from multicol_slam_tpu_torch.slam.system import LOST, NOT_INITIALIZED, WORKING, MultiColSLAM
from multicol_slam_tpu_torch.utils.config import ExtractorSettings, SlamSettings
from torch_jax_draws import JaxDraws

N_FEATS, N_FRAMES, SEED = 250, 40, 3
MAP_FRAMES = 30                 # the JAX system maps frames 0-29 (keyframes on 2, 20 and 28)
LOC_FRAMES = range(20, 30)      # then both track these again, frozen
FIELDS = ("uv", "response", "octave", "angle", "rays", "desc", "dmask", "valid")
MAP = dict(max_keyframes=64, max_points=4000, n_cams=2, feats_per_cam=N_FEATS, n_levels=1, scale_factor=1.2)
FROZEN = ("kf_valid", "kf_pose", "kf_point", "kf_desc", "pt_valid", "pt_X", "pt_desc")


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


def _jsettings():
    return JSettings(fps=25.0, extractor=JExtractor(n_features=N_FEATS, n_levels=1))


def _settings():
    return SlamSettings(fps=25.0, extractor=ExtractorSettings(n_features=N_FEATS, n_levels=1))


def _rig(jrig):
    c = jrig.cams
    return convert.rig_from_numpy(*(np.asarray(getattr(c, k)) for k in ("pol", "invpol", "cde", "pp", "wh")),
                                  np.asarray(jrig.Mc_cayley), device="cpu")


def _port_feats(f):
    return convert.frame_features_from_numpy(**{k: np.asarray(getattr(f, k)) for k in FIELDS}, device="cpu")


@pytest.fixture(scope="module")
def saved_map(world, tmp_path_factory):
    """The JAX system over frames 0-29, its map saved; and every frame's features."""
    slam = JSLAM(world.rig, _jsettings(), JMapConfig(**MAP), use_loop_closing=False, seed=SEED)
    feats = [world.frame_features(t) for t in range(N_FRAMES)]
    for t in range(MAP_FRAMES):
        slam.track(feats=feats[t], timestamp=world.timestamps[t])
    path = str(tmp_path_factory.mktemp("map") / "map.npz")
    jckpt.save_map(path, slam.store)
    assert int(slam.store.kf_valid.sum()) >= 4
    return path, feats


@pytest.fixture(scope="module")
def runs(world, saved_map):
    """Both packages resumed from the file in localization mode over
    LOC_FRAMES; the JAX system set up as its CLI's --load-map does."""
    path, feats = saved_map
    js = JSLAM(world.rig, _jsettings(), JMapConfig(**MAP), use_loop_closing=False, seed=SEED)
    js.store = jckpt.load_map(path)
    js.mapper = JLocalMapper(js.store, world.rig, use_masks=js.use_masks, lock=js.map_lock)
    js.state, js.map_resumed = JLOST, True
    js.activate_localization_mode()
    ts = MultiColSLAM(_rig(world.rig), _settings(), MapConfig(**MAP), use_loop_closing=False, seed=SEED,
                      device="cpu", reloc_sampler=JaxDraws(SEED).reloc)
    ts.resume(tckpt.load_map(path))
    ts.activate_localization_mode()
    assert ts.state == LOST and ts.map_resumed and ts.localization_only
    jm = [js.track(feats=feats[t], timestamp=world.timestamps[t]) for t in LOC_FRAMES]
    tm = [ts.track(feats=_port_feats(feats[t]), timestamp=world.timestamps[t]) for t in LOC_FRAMES]
    return js, ts, jm, tm


def test_states_inliers_and_poses(runs):
    js, ts, jm, tm = runs
    assert [m.state for m in tm] == [m.state for m in jm]
    assert sum(m.state == WORKING for m in tm) >= len(LOC_FRAMES) - 2
    assert [m.n_inliers for m in tm] == [m.n_inliers for m in jm]
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a.pose[3:], b.pose[3:], rtol=0, atol=2e-2)
        np.testing.assert_allclose(a.pose[:3], b.pose[:3], rtol=0, atol=1e-2)


def test_map_is_frozen(runs, saved_map):
    js, ts, _, tm = runs
    loaded = tckpt.load_map(saved_map[0])
    assert not any(m.is_keyframe for m in tm)
    for f in FROZEN:
        np.testing.assert_array_equal(getattr(ts.store, f), getattr(loaded, f), err_msg=f)
        np.testing.assert_array_equal(getattr(js.store, f), getattr(loaded, f), err_msg=f)


def test_deactivate_resumes_insertion(world, runs, saved_map):
    """After localization mode, the port's system maps again: the frames
    past the map's end insert keyframes (culling may retire older ones)."""
    _, ts, _, _ = runs
    feats = saved_map[1]
    ts.deactivate_localization_mode()
    out = [ts.track(feats=_port_feats(feats[t]), timestamp=world.timestamps[t]) for t in range(MAP_FRAMES, N_FRAMES)]
    assert sum(m.is_keyframe for m in out) >= 1 and all(m.state == WORKING for m in out)
    s = ts.store
    assert s.kf_timestamp[s.kf_valid].max() > world.timestamps[MAP_FRAMES - 1]


def _garbage(rng, C=2, K=N_FEATS):
    rays = rng.normal(size=(C, K, 3)).astype(np.float32)
    return convert.frame_features_from_numpy(
        uv=rng.uniform(10, 150, (C, K, 2)).astype(np.float32), response=np.ones((C, K), np.float32),
        octave=np.zeros((C, K), np.int32), angle=np.zeros((C, K), np.float32),
        rays=rays / np.linalg.norm(rays, axis=-1, keepdims=True), desc=rng.integers(0, 256, (C, K, 32), np.uint8),
        dmask=np.full((C, K, 32), 255, np.uint8), valid=np.ones((C, K), bool), device="cpu")


@pytest.mark.parametrize("resumed", [True, False], ids=["resumed", "not_resumed"])
def test_young_resumed_map_is_not_reset(world, saved_map, tmp_path, resumed):
    """A map of <= 3 keyframes (the bootstrap's two), saved by the port's
    save_checkpoint: resumed, a lost frame leaves it in place (state LOST);
    the same map without the flag is reset, as a young map is."""
    feats = saved_map[1]
    young = MultiColSLAM(_rig(world.rig), _settings(), MapConfig(**MAP), use_loop_closing=False, seed=SEED,
                         device="cpu", init_sampler=JaxDraws(SEED).init)
    t = 0
    while young.state != WORKING:
        young.track(feats=_port_feats(feats[t]), timestamp=world.timestamps[t])
        t += 1
    assert int(young.store.kf_valid.sum()) <= 3
    path = str(tmp_path / "young.npz")
    young.save_checkpoint(path)
    saved = tckpt.load_map(path)
    for f in tckpt._ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(saved, f), getattr(young.store, f), err_msg=f)
    np.testing.assert_array_equal(saved.pt_nobs, young.store.pt_nobs)

    slam = MultiColSLAM(_rig(world.rig), _settings(), MapConfig(**MAP), use_loop_closing=False, seed=SEED,
                        device="cpu")
    slam.resume(tckpt.load_map(path))
    slam.map_resumed = resumed
    store = slam.store
    m = slam.track(feats=_garbage(np.random.default_rng(0)), timestamp=99.0)
    if resumed:
        assert m.state == LOST and slam.store is store and int(store.kf_valid.sum()) == int(saved.kf_valid.sum())
    else:
        assert m.state == NOT_INITIALIZED and slam.store is not store and int(slam.store.kf_valid.sum()) == 0
