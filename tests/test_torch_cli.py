"""The port's CLI and eval entry on the CPU, end to end on the eval recipe
(the root eval.py's `_synthetic`: 600 landmarks, 25 frames, 3 cameras, 200
features, 2 levels, the `line` trajectory, seed 7) written by the port's
`write_dataset`.

Gates (tests/test_eval_accuracy.py's, the reference's): >= 15 of 25 frames
tracked and the ATE of MKFTrajectoryLAFIDA.txt under 0.2 m, with
--sync-mapping and with the async default; the async worker without
errors and joined after shutdown; under 0.25 m with mdBRIEF's learned
masks (the settings' extractor.usemdBRIEF and extractor.masks, and the
eval entry's --mdbrief). Then the usage return, the flags that are not
ported yet, and the eval entry's JSON line.
"""
import inspect
import json
import os

import numpy as np
import pytest
import torch

from multicol_slam_tpu_torch import cli
from multicol_slam_tpu_torch import eval as teval
from multicol_slam_tpu_torch.io.render import write_dataset
from multicol_slam_tpu_torch.io.synthetic import make_world
from multicol_slam_tpu_torch.io.trajectory import ate_rmse, load_tum_trajectory

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


def test_sync_mapping(dataset, tmp_path, monkeypatch):
    rc, slam, worker = _run(dataset, tmp_path, monkeypatch, "--sync-mapping", "--metrics", "m.jsonl")
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


@pytest.mark.parametrize("flag", cli.UNPORTED_FLAGS)
def test_unported_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        cli.main(["a", "b", "c", "d", flag, "x"], device="cpu")


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


@pytest.mark.parametrize("fn", [cli.main, teval.main], ids=["cli", "eval"])
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


@pytest.mark.parametrize("flag", ["--mdbrief", "--selfcal"])
def test_eval_unported_modes_raise(flag, tmp_path, capsys):
    """--selfcal is not ported yet and raises; --mdbrief runs the eval
    recipe with mdBRIEF's learned masks at the reference's gates: >= 15 of
    25 frames tracked, ATE < 0.25 m (tests/test_eval_accuracy.py:49-61)."""
    if flag == "--selfcal":
        with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
            teval.main([flag], device="cpu")
        return
    assert teval.main([flag, "--frames", str(N_FRAMES), "--out", str(tmp_path / "ev")], device="cpu") == 0
    r = json.loads([ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")][-1])
    assert r["metric"] == "synthetic_lafida_ate_rmse_mdbrief" and r["descriptor"] == "mdBRIEF+masks"
    assert r["frames_tracked"] >= 15 and r["value"] < 0.25, r


def test_eval_real_calib_skips_without_the_files(tmp_path, capsys):
    assert teval.main(["--real-calib", "--calib-dir", str(tmp_path / "absent")], device="cpu") == 0
    r = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert r["metric"] == "real_calib_ate_rmse" and r["value"] is None and "skipped" in r
