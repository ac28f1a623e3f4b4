"""CPU tests of the plain references against the port at small sizes: the
ORB extraction on a frame of the benchmark's world, the two-stage tracking
against a local map made of the frame's own features, and the LM bundle
adjustment on a small draw of the large-map problem. The references import
nothing of the port; these tests import both.

    python3 -m pytest benchmark/test_bm_reference.py -q
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import baproblem
from benchmark.reference import ba as ref_ba
from benchmark.reference import orb as ref_orb
from benchmark.reference import tracking as ref_track
from benchmark.reference.geometry import Rig
from benchmark.world import RoomWorld

ROOT = Path(__file__).resolve().parent.parent
ORB = json.loads((ROOT / "benchmark/configs/lafida3-orb.json").read_text())
BA = json.loads((ROOT / "benchmark/configs/ba-64kf-50k.json").read_text())


@pytest.fixture(scope="module")
def frame():
    """(reference rig, port rig, port features, image) of frame 1."""
    from multicol_slam_tpu_torch.models.camera import OmniCamera
    from multicol_slam_tpu_torch.models.rig import MultiCamRig
    from multicol_slam_tpu_torch.slam.features import ExtractorTables, extract_features
    from multicol_slam_tpu_torch.utils.config import ExtractorSettings

    torch.set_num_threads(4)
    r, C = ORB["rig"], ORB["rig"]["n_cams"]
    rig = Rig(r, "cpu")
    world = RoomWorld(ORB["world"], rig, 2 ** 31 + 101, "cpu", n_render=2)
    cams = OmniCamera.from_params([r["pol"]] * C, [r["invpol"]] * C, [[1.0, 0.0, 0.0]] * C, [[377.0, 240.0]] * C,
                                  [[754.0, 480.0]] * C, device="cpu")
    prig = MultiCamRig.from_cayley(cams, torch.tensor(r["mc_cayley"]))
    s = ORB["settings"]
    ex = ExtractorSettings(n_features=s["n_features"], n_levels=s["n_levels"], scale_factor=s["scale_factor"],
                           fast_th=s["fast_th"])
    feats = extract_features(world.images[1], cams, ex, ExtractorTables(ex, 480, 754, device="cpu"))
    return rig, prig, feats, world.images[1]


def test_orb_reference_equals_the_port(frame):
    rig, _, f, img = frame
    ref = ref_orb.extract(img, ORB["settings"], rig.pp, rig.wh)
    assert torch.equal(f.valid, ref["valid"]) and int(f.valid.sum()) > 900
    v = f.valid
    assert torch.equal(f.uv[v], ref["uv"][v]) and torch.equal(f.octave[v], ref["octave"][v])
    assert torch.equal(f.desc[v], ref["desc"][v]) and torch.equal(f.angle[v], ref["angle"][v])


def test_tracking_reference_follows_the_port(frame):
    from multicol_slam_tpu_torch import bench
    from multicol_slam_tpu_torch.slam.tracking_kernels import track_frame_fused

    rig, prig, f, _ = frame
    X, D, n = bench.local_map(f.valid.numpy(), f.rays.numpy(), f.desc.numpy(), prig.Mc.numpy(),
                              np.random.default_rng(0))
    pts = bench.local_points(X, D, n, 4096, "cpu")._replace(normal=torch.zeros(4096, 3))
    pose0 = torch.tensor(bench.POSE0, dtype=torch.float32)
    from benchmark.check import unpack
    prog = unpack(track_frame_fused(prig.Mc_cayley.float(), prig.cams.to_vector(), prig.cams, f, pose0, pts, pts,
                                    radius1=15.0, radius2=4.0, th_desc=96.0).numpy())
    feats = {k: getattr(f, k) for k in ("uv", "octave", "desc", "valid")}
    ref = ref_track.track(rig, feats, pose0, pts._asdict(), ORB["settings"])
    assert prog["n_inliers"] == ref["n_inliers"] > 100
    assert np.abs(prog["pose"] - ref["pose"].numpy()).max() < 1e-5
    assert np.array_equal(np.where(prog["inlier"], prog["assign"], -1),
                          np.where(ref["inlier"].numpy(), ref["assign"].numpy(), -1))


def test_motion_model_prediction():
    v = np.eye(4, dtype=np.float32)
    v[0, 3] = 0.05
    p = ref_track.predict(np.array([0.0, 0.0, 0.0, 1.0, 2.0, 3.0], np.float32), v)
    assert np.allclose(p, [0, 0, 0, 1.05, 2.0, 3.0], atol=1e-7)


def test_ba_reference_follows_the_port():
    from multicol_slam_tpu_torch.optim.lm import LMConfig, lm_solve
    from multicol_slam_tpu_torch.optim.problem import BAParams, FreeMask, Observations

    cfg = json.loads(json.dumps(BA))
    cfg["problem"].update(n_kfs=8, n_points=2000, n_obs=20000)
    rig = Rig(cfg["rig"], "cpu")
    pr = baproblem.draw(cfg, rig, 2 ** 31 + 7, "cpu")
    assert pr.valid.float().mean() > 0.5 and torch.equal(pr.pt, pr.pt.sort().values)
    lm = cfg["lm"]
    out, cost = lm_solve(BAParams(pr.poses, pr.points, pr.mc, pr.intr),
                         Observations(pr.kf, pr.pt, pr.cam, pr.uv, torch.ones(len(pr.kf)), pr.valid),
                         FreeMask(pr.free_poses, torch.ones(pr.points.shape[0], dtype=torch.bool)),
                         LMConfig(max_iters=10, cg_iters=20, gain_eps=0.0))
    poses, _, ref_cost = ref_ba.solve(pr, lm)
    start = ref_ba.robust_cost(*ref_ba.residuals(pr.poses, pr.points, pr.mc, pr.intr, pr.kf, pr.pt, pr.cam, pr.uv),
                               pr.valid, lm["huber_delta"])
    assert float(ref_cost) < 0.5 * float(start)
    assert abs(float(cost) - float(ref_cost)) / float(ref_cost) < 1e-5
    assert float((out.poses - poses).abs().max()) < 1e-2
