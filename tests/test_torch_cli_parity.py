"""Both CLIs, --sync-mapping, on one dataset that the JAX package's
`write_dataset` wrote (the root eval.py's recipe: 600 landmarks, 25 frames,
3 cameras, 200 features, 2 levels, the `line` trajectory, seed 7), each
scored by `ate_rmse` on its MKFTrajectoryLAFIDA.txt. The port's system draws
JAX's RANSAC hypotheses (tests/torch_jax_draws.py), fed through a partial
of the CLI's MultiColSLAM.

Tolerances: the same initialization frame +-1 (extraction agrees to >= 99 %,
not exactly: ROADMAP Queue 3, slice 1); frames tracked within 2; keyframes
within 1; both ATEs under the reference's 0.2 m and within 0.05 m of each
other. The JAX CLI run is the module's fixture (its XLA compiles take most
of its time).
"""
import functools
import json
import os

import pytest
import torch

from multicol_slam_tpu import cli as jcli
from multicol_slam_tpu.io.render import write_dataset
from multicol_slam_tpu.io.synthetic import make_world
from multicol_slam_tpu.io.trajectory import ate_rmse, load_tum_trajectory
from multicol_slam_tpu_torch import cli as tcli
from torch_jax_draws import JaxDraws

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


def _run(main, dataset, out_dir):
    """main (a CLI's) with --sync-mapping and --metrics in out_dir ->
    (first tracked frame, frames tracked, keyframes, ATE)."""
    world, d = dataset
    cwd = os.getcwd()
    os.chdir(out_dir)
    try:
        main(["no_voc.yml", os.path.join(d, "Slam_Settings_synthetic.yaml"), d, d, "--sync-mapping",
              "--metrics", "metrics.jsonl"])
    finally:
        os.chdir(cwd)
    lines = [json.loads(ln) for ln in open(os.path.join(out_dir, "metrics.jsonl"))]
    frames, summary = lines[:-1], lines[-1]
    tracked = [f["frame"] for f in frames if f["state"] == 3]
    t, p = load_tum_trajectory(os.path.join(out_dir, "MKFTrajectoryLAFIDA.txt"))
    return dict(first=tracked[0] if tracked else None, tracked=len(tracked), n_kf=summary["n_keyframes"],
                ate=float(ate_rmse(t, p, world.timestamps, world.poses[:, 3:6])))


@pytest.fixture(scope="module")
def jax_run(dataset, tmp_path_factory):
    return _run(jcli.main, dataset, str(tmp_path_factory.mktemp("jax")))


@pytest.fixture(scope="module")
def port_run(dataset, tmp_path_factory):
    draws = JaxDraws(0)   # the JAX CLI's system seed
    mp = pytest.MonkeyPatch()
    mp.setattr(tcli, "MultiColSLAM", functools.partial(tcli.MultiColSLAM, init_sampler=draws.init,
                                                       reloc_sampler=draws.reloc))
    try:
        return _run(functools.partial(tcli.main, device="cpu"), dataset, str(tmp_path_factory.mktemp("port")))
    finally:
        mp.undo()


def test_same_initialization(jax_run, port_run):
    assert jax_run["first"] is not None and abs(port_run["first"] - jax_run["first"]) <= 1, (port_run, jax_run)


def test_frames_tracked_and_keyframes(jax_run, port_run):
    assert jax_run["tracked"] >= 15 and abs(port_run["tracked"] - jax_run["tracked"]) <= 2, (port_run, jax_run)
    assert abs(port_run["n_kf"] - jax_run["n_kf"]) <= 1, (port_run, jax_run)


def test_trajectory_accuracy(jax_run, port_run):
    assert jax_run["ate"] < 0.2 and port_run["ate"] < 0.2, (port_run, jax_run)
    assert abs(port_run["ate"] - jax_run["ate"]) <= 0.05, (port_run, jax_run)
