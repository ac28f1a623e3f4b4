"""The port's viewer (`io/viz.py`) against the JAX package's
(tests/test_viz.py's cases on the port, then the two side by side).

Both write PNGs through matplotlib where it imports, else `.npz` dumps;
the card's machine has no matplotlib, so the `.npz` branch is the one that
runs there and is checked here with `_mpl` patched to None. The map dump of
the same store (one store, carried between the packages by a checkpoint)
holds the same points exactly and keyframe poses within 1e-6 (each package
turns the Cayley poses into matrices in float32); the frustum segments
are equal to the last bit (the same numpy).
"""
import numpy as np
import pytest

from multicol_slam_tpu.io import checkpoint as jckpt
from multicol_slam_tpu.io import viz as jviz
from multicol_slam_tpu.io.synthetic import make_world as jmake_world
from multicol_slam_tpu_torch.io import checkpoint as tckpt
from multicol_slam_tpu_torch.io import viz as tviz
from multicol_slam_tpu_torch.io.synthetic import make_world
from multicol_slam_tpu_torch.slam.map_store import MapConfig, MapStore
from multicol_slam_tpu_torch.slam.system import MultiColSLAM
from multicol_slam_tpu_torch.utils.config import ExtractorSettings, SlamSettings


def _small_store(world, n_kf=3, n_pts=50):
    cfg = MapConfig(max_keyframes=8, max_points=256, n_cams=world.rig.n_cams, feats_per_cam=world.n_feats,
                    n_levels=4)
    s = MapStore(cfg)
    for t in range(n_kf):
        s.add_keyframe(world.poses[t], world.frame_features(t, device="cpu"), float(t), t)
    for i in range(n_pts):
        p = s.add_point(world.points[i], world.descs[i], np.full(32, 255, np.uint8), first_kf=0,
                        normal=np.zeros(3, np.float32), min_dist=0.1, max_dist=25.0)
        s.add_observation(0, i, p)
        s.add_observation(1, i, p)
    return s


def test_render_map_and_frame(tmp_path):
    world = make_world(n_points=120, n_frames=4, n_cams=2, n_feats=48, seed=1)
    s = _small_store(world)
    out = tmp_path / "map.png"
    ok = tviz.render_map(s, world.rig, str(out), current_pose6=world.poses[2])
    assert (out.exists() and out.stat().st_size > 0) or not ok

    C, K = world.rig.n_cams, world.n_feats
    images = np.random.default_rng(0).uniform(0, 255, (C, 96, 128))
    feats = world.frame_features(0, device="cpu")
    tracked = np.zeros((C, K), bool)
    tracked[:, :10] = True
    fout = tmp_path / "frame.png"
    ok = tviz.render_frame(images, feats.uv.numpy(), feats.valid.numpy(), tracked, 3, str(fout), n_inliers=10)
    assert (fout.exists() and fout.stat().st_size > 0) or not ok


def _track(tmp_path, n_frames=2):
    """A Visualizer on a live system (every frame) over n_frames frames."""
    world = make_world(n_points=200, n_frames=3, n_cams=2, n_feats=48, seed=2)
    settings = SlamSettings(extractor=ExtractorSettings(n_features=48, n_levels=2, desc_size=32))
    slam = MultiColSLAM(world.rig, settings, map_cfg=MapConfig(max_keyframes=16, max_points=2048, n_cams=2,
                                                               feats_per_cam=48, n_levels=2),
                        use_loop_closing=False, device="cpu")
    viz = tviz.Visualizer(str(tmp_path), every=1)
    images = np.zeros((2, 96, 128), np.float32)
    for t in range(n_frames):
        m = slam.track(feats=world.frame_features(t, device="cpu"), timestamp=float(t))
        viz.update(slam, images, m)
    return slam


def test_visualizer_update(tmp_path):
    """Visualizer consumes a live MultiColSLAM snapshot without error."""
    _track(tmp_path)
    assert any(p.name.startswith("frame_") for p in tmp_path.iterdir())


def test_npz_branch_without_matplotlib(tmp_path, monkeypatch):
    """Without matplotlib every update writes frame_XXXXXX.png.npz (uv,
    valid, tracked) and map_XXXXXX.png.npz (points, kf_poses)."""
    monkeypatch.setattr(tviz, "_mpl", lambda: None)
    slam = _track(tmp_path, n_frames=3)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == [f"{k}_{t:06d}.png.npz" for k in ("frame", "map") for t in range(3)]
    with np.load(tmp_path / "frame_000002.png.npz") as d:
        assert sorted(d.files) == ["tracked", "uv", "valid"]
        assert d["uv"].shape == (2, 48, 2) and d["valid"].shape == d["tracked"].shape == (2, 48)
        assign = slam.last_assign_global
        tracked = np.zeros(96, bool) if assign is None else assign >= 0
        np.testing.assert_array_equal(d["tracked"].reshape(-1), tracked)
    with np.load(tmp_path / "map_000002.png.npz") as d:
        assert sorted(d.files) == ["kf_poses", "points"]
        assert d["kf_poses"].shape == (int(slam.store.kf_valid.sum()), 4, 4)
        assert d["points"].shape == (int(slam.store.pt_valid.sum()), 3)


def test_map_dump_and_frusta_match_jax(tmp_path, monkeypatch):
    world = make_world(n_points=120, n_frames=4, n_cams=2, n_feats=48, seed=1)
    jworld = jmake_world(n_points=120, n_frames=4, n_cams=2, n_feats=48, seed=1)
    s = _small_store(world)
    tckpt.save_map(str(tmp_path / "map.npz"), s)
    js = jckpt.load_map(str(tmp_path / "map.npz"))
    monkeypatch.setattr(tviz, "_mpl", lambda: None)
    monkeypatch.setattr(jviz, "_mpl", lambda: None)
    assert not tviz.render_map(s, world.rig, str(tmp_path / "t"))
    assert not jviz.render_map(js, jworld.rig, str(tmp_path / "j"))
    with np.load(tmp_path / "t.npz") as a, np.load(tmp_path / "j.npz") as b:
        np.testing.assert_array_equal(a["points"], b["points"])
        np.testing.assert_allclose(a["kf_poses"], b["kf_poses"], rtol=0, atol=1e-6)
    rng = np.random.default_rng(3)
    for scale in (0.12, 0.18):
        M = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        MtMc = np.eye(4)
        MtMc[:3, :3], MtMc[:3, 3] = M, rng.normal(size=3)
        np.testing.assert_array_equal(tviz._frustum_lines(MtMc, scale), jviz._frustum_lines(MtMc, scale))


@pytest.mark.parametrize("on", [True, False], ids=["matplotlib", "npz"])
def test_render_frame_returns_what_it_wrote(on, tmp_path, monkeypatch):
    if not on:
        monkeypatch.setattr(tviz, "_mpl", lambda: None)
    elif tviz._mpl() is None:
        pytest.skip("matplotlib is not installed")
    C, K = 2, 8
    ok = tviz.render_frame(np.zeros((C, 16, 16)), np.zeros((C, K, 2)), np.ones((C, K), bool),
                           np.zeros((C, K), bool), 4, str(tmp_path / "f.png"))
    assert ok is on and (tmp_path / ("f.png" if on else "f.png.npz")).exists()
