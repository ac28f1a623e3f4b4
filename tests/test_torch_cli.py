"""The port's CLI and eval entry on the CPU, end to end on the eval recipe
(the root eval.py's `_synthetic`: 600 landmarks, 25 frames, 3 cameras, 200
features, 2 levels, the `line` trajectory, seed 7) written by the port's
`write_dataset`.

Gates (tests/test_eval_accuracy.py's, the reference's): >= 15 of 25 frames
tracked and the ATE of MKFTrajectoryLAFIDA.txt under 0.2 m, with
--sync-mapping and with the async default; the async worker without
errors and joined after shutdown; under 0.25 m with mdBRIEF's learned
masks (the settings' extractor.usemdBRIEF and extractor.masks, and the
eval entry's --mdbrief). Then the usage return and the eval entry's JSON
line.

The map flags (io/checkpoint.py), on one sync run that saves its map and
draws the viewer's files every 10 frames: the saved file holds the live
store at exit; --load-map --localization over frames 12-24 leaves the
loaded map exactly as it was (no keyframe inserted); --load-map async
resumes on the worker with the new mapper wired to it; --profile writes a
trace of 5 frames and the tracer's spans; eval --selfcal at 40 frames reaches the reference's 10x
(tests/test_eval_accuracy.py:100-110).
"""
import inspect
import json
import os

import numpy as np
import pytest
import torch

from multicol_slam_tpu_torch import cli
from multicol_slam_tpu_torch import eval as teval
from multicol_slam_tpu_torch import longrun
from multicol_slam_tpu_torch.io import checkpoint, viz
from multicol_slam_tpu_torch.io.render import write_dataset
from multicol_slam_tpu_torch.io.synthetic import make_world
from multicol_slam_tpu_torch.io.trajectory import ate_rmse, load_tum_trajectory
from multicol_slam_tpu_torch.utils import tracing

N_FRAMES = 25


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the system's ops are small, and the tier-1 run
    puts six test processes on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    world = make_world(n_points=600, n_frames=N_FRAMES, n_cams=3, n_feats=200, noise_px=0.0, trajectory="line",
                       seed=7)
    d = str(tmp_path_factory.mktemp("ds"))
    write_dataset(world, d)
    return world, d


def _run(dataset, tmp_path, monkeypatch, *extra, voc="no_voc.yml"):
    """cli.main on the CPU in tmp_path; returns (exit code, the system)."""
    world, d = dataset
    made = []
    orig = cli.MultiColSLAM

    def recording(*a, **kw):
        made.append(orig(*a, **kw))
        made.append(made[-1]._worker)
        return made[0]
    monkeypatch.setattr(cli, "MultiColSLAM", recording)
    monkeypatch.chdir(tmp_path)
    rc = cli.main([voc, os.path.join(d, "Slam_Settings_synthetic.yaml"), d, d, *extra], device="cpu")
    return rc, made[0], made[1]


def _ate(world, path):
    t, p = load_tum_trajectory(str(path))
    return len(t), ate_rmse(t, p, world.timestamps, world.poses[:, 3:6])


@pytest.fixture(scope="module")
def mapped(dataset, tmp_path_factory):
    """The sync run (--sync-mapping --metrics) with --save-map and --viz
    every 10 frames: its exit code, the system, its worker (None), the map
    file and the run's directory."""
    run_dir = tmp_path_factory.mktemp("mapped")
    mp = pytest.MonkeyPatch()
    try:
        rc, slam, worker = _run(dataset, run_dir, mp, "--sync-mapping", "--metrics", "m.jsonl", "--save-map",
                                str(run_dir / "map.npz"), "--viz", str(run_dir / "viz"), "--viz-every", "10")
    finally:
        mp.undo()
    return rc, slam, worker, str(run_dir / "map.npz"), run_dir


def test_sync_mapping(dataset, mapped):
    rc, slam, worker, _, tmp_path = mapped
    assert rc == 0 and worker is None and not slam.async_mapping
    n, ate = _ate(dataset[0], tmp_path / "MKFTrajectoryLAFIDA.txt")
    assert n >= 15 and ate < 0.2, (n, ate)
    # the Lafida TUM format: timestamp, position, unit quaternion, one line a tracked frame
    rows = np.loadtxt(tmp_path / "MKFTrajectoryLAFIDA.txt", ndmin=2)
    assert rows.shape == (n, 8) and np.all(np.diff(rows[:, 0]) > 0)
    np.testing.assert_allclose(np.linalg.norm(rows[:, 4:], axis=1), 1.0, atol=1e-5)
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert len(lines) == N_FRAMES + 1
    frames = [json.loads(ln) for ln in lines[:-1]]
    assert [f["frame"] for f in frames] == list(range(N_FRAMES))
    assert sum(f["state"] == 3 for f in frames) == n
    summary = json.loads(lines[-1])
    assert summary["summary"] and summary["kf_deferred_mapper_busy"] == 0 and summary["n_keyframes"] >= 3


def test_async_default(dataset, tmp_path, monkeypatch, capsys):
    """The async default (the reference CLI's), a vocabulary file that fails
    to load (the loop closer trains its own, as the reference prints)."""
    bad = tmp_path / "voc.yml"
    bad.write_text('vocabulary:\n  k: 9\n  nodes:\n  - { nodeId:abc, parentId:0, weight:0, descriptor:"1 2" }\n')
    rc, slam, worker = _run(dataset, tmp_path, monkeypatch, voc=str(bad))
    assert "vocabulary load failed" in capsys.readouterr().out
    assert rc == 0 and slam.async_mapping and slam.worker_errors == []
    assert worker is not None and not worker.is_alive() and slam._worker is None
    n, ate = _ate(dataset[0], tmp_path / "MKFTrajectoryLAFIDA.txt")
    assert n >= 15 and ate < 0.2, (n, ate)


def test_usage(capsys):
    assert cli.main(["only", "three", "args"], device="cpu") == 1
    assert "Usage" in capsys.readouterr().out


def test_save_map(mapped):
    """The file holds the store as it was at exit, pt_nobs recounted equal
    to the maintained one."""
    _, slam, _, path, _ = mapped
    loaded = checkpoint.load_map(path)
    for f in checkpoint._ARRAY_FIELDS + ["pt_nobs"]:
        np.testing.assert_array_equal(getattr(loaded, f), getattr(slam.store, f), err_msg=f)
    assert (loaded.n_kf, loaded.n_pt_alloc, loaded._free_kf, loaded._free_pt, loaded.loop_edges) == (
        slam.store.n_kf, slam.store.n_pt_alloc, slam.store._free_kf, slam.store._free_pt, slam.store.loop_edges)
    assert int(loaded.kf_valid.sum()) >= 3


def test_viz(mapped):
    """--viz DIR --viz-every 10 over 25 frames: frames 0, 10 and 20, a frame
    and a map artifact each (PNGs here; .npz where matplotlib is absent)."""
    names = sorted(p.name for p in (mapped[4] / "viz").iterdir())
    ext = ".png" if viz._mpl() is not None else ".png.npz"
    assert names == [f"{k}_{t:06d}{ext}" for k in ("frame", "map") for t in (0, 10, 20)]


def _resumed(dataset, mapped, tmp_path, monkeypatch, capsys, *extra, start=13, end=0):
    """cli.main --load-map over the dataset's frames [start - 1, end - 1)."""
    _, d = dataset
    settings = tmp_path / "s.yaml"
    settings.write_text(open(os.path.join(d, "Slam_Settings_synthetic.yaml")).read())
    teval.set_yaml_keys(str(settings), {"traj.StartFrame": start, **({"traj.EndFrame": end} if end else {})})
    made = []
    orig = cli.MultiColSLAM
    monkeypatch.setattr(cli, "MultiColSLAM", lambda *a, **kw: made.append(orig(*a, **kw)) or made[-1])
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["no_voc.yml", str(settings), d, d, "--load-map", mapped[3], *extra], device="cpu")
    return rc, made[0], capsys.readouterr().out


def test_load_map_localization(dataset, mapped, tmp_path, monkeypatch, capsys):
    """--load-map --localization (sync) over frames 12-24: the system
    resumes LOST on the loaded map, re-acquires its pose in it, tracks, and
    leaves every keyframe and point as loaded."""
    rc, slam, out = _resumed(dataset, mapped, tmp_path, monkeypatch, capsys, "--localization", "--sync-mapping")
    loaded = checkpoint.load_map(mapped[3])
    assert rc == 0 and slam.map_resumed and slam.localization_only
    assert f"resumed map: {int(loaded.kf_valid.sum())} keyframes, {int(loaded.pt_valid.sum())} points" in out
    assert len(slam.trajectory) == 13 and not any(m.is_keyframe for m in slam.trajectory)
    assert sum(m.state == 3 for m in slam.trajectory) >= 10
    for f in ("kf_valid", "kf_pose", "kf_point", "pt_valid", "pt_X", "pt_desc"):
        np.testing.assert_array_equal(getattr(slam.store, f), getattr(loaded, f), err_msg=f)


def test_load_map_async(dataset, mapped, tmp_path, monkeypatch, capsys):
    """--load-map with the async worker: the resumed store's mapper and
    loop closer are the worker's (its gate and the shared lock), the run
    ends without a worker error, the worker joined."""
    rc, slam, out = _resumed(dataset, mapped, tmp_path, monkeypatch, capsys)
    assert rc == 0 and slam.async_mapping and slam.map_resumed and not slam.localization_only
    assert "resumed map:" in out and slam.worker_errors == [] and slam._worker is None
    assert slam.mapper.store is slam.store and slam.loop_closer.store is slam.store
    assert slam.mapper.yield_gate == slam._yield_to_tracker == slam.loop_closer.yield_gate
    assert slam.mapper.lock is slam.map_lock and slam.loop_closer.lock is slam.map_lock
    assert sum(m.state == 3 for m in slam.trajectory) >= 10


def test_profile(dataset, tmp_path, monkeypatch, capsys):
    """--profile DIR over 5 frames: a Chrome trace of the tracking loop,
    with the program's mcs.* ranges, and the tracer's records as
    spans.json; the tracer is off again after the run."""
    _, d = dataset
    settings = tmp_path / "s.yaml"
    settings.write_text(open(os.path.join(d, "Slam_Settings_synthetic.yaml")).read())
    teval.set_yaml_keys(str(settings), {"traj.EndFrame": 6})
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["no_voc.yml", str(settings), d, d, "--sync-mapping", "--profile", str(tmp_path / "prof")],
                  device="cpu")
    assert rc == 0 and f"profiler trace written to {tmp_path / 'prof'}" in capsys.readouterr().out
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert len(trace["traceEvents"]) > 100 and any(n.startswith("aten::") for n in names)
    assert {"mcs.system.track_begin", "mcs.track.fused", "mcs.track.pose", "mcs.k1"} <= names
    spans = json.loads((tmp_path / "prof" / "spans.json").read_text())
    begins = [r for r in spans if r["name"] == "system.track_begin"]
    assert len(begins) == 5 and {r["request"][0] for r in begins} == {"frame"}
    k1 = [r for r in spans if r["name"] == "k1"]
    assert k1 and all(r["counts"]["P"] >= 0 and r["counts"]["C"] == 3 for r in k1)
    assert not tracing.TRACER.enabled and tracing.records() == []


def test_mdbrief_masks_raise(dataset, tmp_path, monkeypatch):
    """Settings that turn on mdBRIEF with learned masks run the CLI (sync):
    the system matches masked, and the trajectory file it writes holds the
    reference's gates (>= 15 of 25 tracked, ATE < 0.25 m,
    tests/test_eval_accuracy.py:49-61)."""
    _, d = dataset
    text = open(os.path.join(d, "Slam_Settings_synthetic.yaml")).read()
    settings = tmp_path / "s.yaml"
    settings.write_text(text.replace("extractor.usemdBRIEF: 0", "extractor.usemdBRIEF: 1")
                        .replace("extractor.masks: 0", "extractor.masks: 1"))
    monkeypatch.chdir(tmp_path)
    made = []
    orig = cli.MultiColSLAM
    monkeypatch.setattr(cli, "MultiColSLAM", lambda *a, **kw: made.append(orig(*a, **kw)) or made[-1])
    assert cli.main(["no_voc.yml", str(settings), d, d, "--sync-mapping"], device="cpu") == 0
    assert made[0].use_masks and made[0].th_low == 32.0
    n, ate = _ate(dataset[0], tmp_path / "MKFTrajectoryLAFIDA.txt")
    assert n >= 15 and ate < 0.25, (n, ate)


@pytest.mark.parametrize("fn", [cli.main, teval.main, longrun.main], ids=["cli", "eval", "longrun"])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_eval_entry(tmp_path, capsys):
    """The eval entry (sync) prints one JSON line with the reference's keys."""
    assert teval.main(["--frames", str(N_FRAMES), "--out", str(tmp_path / "ev")], device="cpu") == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")][-1]
    r = json.loads(line)
    assert set(r) == {"metric", "value", "unit", "frames_tracked", "n_frames", "seed", "wall_s", "platform",
                      "pipeline", "descriptor"}
    assert r["metric"] == "synthetic_lafida_ate_rmse" and r["platform"] == "cpu" and r["pipeline"] == "sync"
    assert r["frames_tracked"] >= 15 and r["value"] < 0.2, r


@pytest.mark.parametrize("flag", ["--mdbrief"])
def test_eval_unported_modes_raise(flag, tmp_path, capsys):
    """--mdbrief runs the eval recipe with mdBRIEF's learned masks at the
    reference's gates: >= 15 of 25 frames tracked, ATE < 0.25 m
    (tests/test_eval_accuracy.py:49-61)."""
    assert teval.main([flag, "--frames", str(N_FRAMES), "--out", str(tmp_path / "ev")], device="cpu") == 0
    r = json.loads([ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")][-1])
    assert r["metric"] == "synthetic_lafida_ate_rmse_mdbrief" and r["descriptor"] == "mdBRIEF+masks"
    assert r["frames_tracked"] >= 15 and r["value"] < 0.25, r


def test_eval_selfcal(capsys):
    """eval --selfcal --frames 40: the reference's gate, a 10x reduction of
    the injected extrinsic error, and its JSON keys."""
    assert teval.main(["--selfcal", "--frames", "40"], device="cpu") == 0
    r = json.loads([ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")][-1])
    assert set(r) == {"metric", "value", "unit", "err_injected", "err_recovered", "n_keyframes", "n_obs", "platform"}
    assert r["metric"] == "selfcal_extrinsic_error_reduction" and r["value"] >= 10.0, r


@pytest.mark.parametrize("mode, frames, expect", [
    ("--selfcal", None, 60), ("--selfcal", 35, 35), ("--real-calib", None, 40), ("--real-calib", 35, 35),
    (None, None, 35), (None, 20, 20)])
def test_eval_frames_default_per_mode(mode, frames, expect, monkeypatch):
    """Each mode's own frame count unless --frames is given, and an explicit
    --frames 35 (the synthetic mode's default) is taken as given."""
    seen = []
    monkeypatch.setattr(teval, "_selfcal", lambda n, device: seen.append(n) or 0)
    monkeypatch.setattr(teval, "_real_calib", lambda n, *a: seen.append(n) or 0)
    monkeypatch.setattr(teval, "_synthetic", lambda n, *a: seen.append(n) or {"value": 0.0})
    argv = ([mode] if mode else []) + (["--frames", str(frames)] if frames else [])
    assert teval.main(argv, device="cpu") == 0
    assert seen == [expect]


def test_eval_real_calib_skips_without_the_files(tmp_path, capsys):
    assert teval.main(["--real-calib", "--calib-dir", str(tmp_path / "absent")], device="cpu") == 0
    r = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert r["metric"] == "real_calib_ate_rmse" and r["value"] is None and "skipped" in r
