"""The mdBRIEF cell's plain references (benchmark/reference/mdbrief.py,
tracking_masked.py) against the port, its runner through the harness, and
the port's extraction spans, on the CPU at small sizes.

The references import nothing of the port or JAX (an AST walk); the masked
distance equals the port's dense one exactly; the port's mdBRIEF extraction
equals the reference on a frame of the benchmark's world; the masked
two-stage tracking agrees with the reference on a local map made of the
frame's own features; the cell runs and comes out correct in a process of
its own; the `features.extract` / `features.describe` spans and the
describe counters are recorded with the tracer on and not with it off; and the cell's two
metric readers read None where there is nothing to read.
"""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import mdbrief as ref_md
from benchmark.reference import tracking as ref_plain
from benchmark.reference import tracking_masked as ref_track
from benchmark.reference.geometry import Rig
from benchmark.world import RoomWorld
from multicol_slam_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parent.parent
CFG = json.loads((ROOT / "benchmark/configs/lafida3-mdbrief.json").read_text())
# fewer levels and features than the configuration: the same code at a
# CPU test's cost
SMALL = dict(CFG["settings"], n_features=150, n_levels=3)


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def _port_rig():
    from multicol_slam_tpu_torch.models.camera import OmniCamera
    from multicol_slam_tpu_torch.models.rig import MultiCamRig

    r, C = CFG["rig"], CFG["rig"]["n_cams"]
    W, H = float(r["width"]), float(r["height"])
    cams = OmniCamera.from_params([r["pol"]] * C, [r["invpol"]] * C, [[1.0, 0.0, 0.0]] * C, [[W / 2, H / 2]] * C,
                                  [[W, H]] * C, device="cpu")
    return MultiCamRig.from_cayley(cams, torch.tensor(r["mc_cayley"][:C], dtype=torch.float32))


def _settings(spec):
    from multicol_slam_tpu_torch.utils.config import ExtractorSettings

    return ExtractorSettings(use_mdbrief=spec["use_mdbrief"], learn_masks=spec["learn_masks"],
                             n_features=spec["n_features"], n_levels=spec["n_levels"],
                             scale_factor=spec["scale_factor"], fast_th=spec["fast_th"], desc_size=spec["desc_size"])


@pytest.fixture(scope="module")
def frame():
    """(reference rig, port rig, port features, reference features, image)
    of frame 2 of the benchmark's world."""
    from multicol_slam_tpu_torch.slam.features import extract_features

    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    rig = Rig(CFG["rig"], "cpu")
    world = RoomWorld(CFG["world"], rig, 2 ** 31 + 171, "cpu", n_render=3)
    prig = _port_rig()
    img = world.images[2]
    feats = extract_features(img, prig.cams, _settings(SMALL))
    ref = ref_md.extract(img, SMALL, rig)
    yield rig, prig, feats, ref, img
    torch.set_num_threads(threads)


def _bits(x: torch.Tensor) -> torch.Tensor:
    w = (1 << torch.arange(8)).to(torch.uint8)
    return ((x[..., None] & w) > 0).flatten(-2)


def test_masked_distance_equals_the_port():
    """(a) The reference's masked distance is the port's dense masked
    Hamming, exactly (both are halves of integers); with every mask 0xFF it
    is the plain Hamming distance."""
    from multicol_slam_tpu_torch.ops.matching import hamming_matrix, hamming_matrix_masked

    g = torch.Generator().manual_seed(17)

    def draw(n):
        return torch.randint(0, 256, (n, 32), generator=g, dtype=torch.int32).to(torch.uint8)
    a, ma, b, mb = draw(70), draw(70), draw(90), draw(90)
    ma[:5] = 0                                  # nothing kept on one side
    got = ref_track.hamming_masked(a, ma, b, mb)
    assert torch.equal(got, hamming_matrix_masked(a, ma, b, mb))
    assert torch.equal(got * 2, got.mul(2).round())
    full_a, full_b = torch.full_like(a, 255), torch.full_like(b, 255)
    plain = ref_track.hamming_masked(a, full_a, b, full_b)
    assert torch.equal(plain, ref_plain.hamming(a, b).float())
    assert torch.equal(plain, hamming_matrix(a, b))


def test_mdbrief_reference_equals_the_port(frame):
    """(b) Level-0 keypoints exact; descriptor and mask bits at least 99 %
    equal, and exact on every keypoint whose three distorted patterns (the
    unturned one and +-20 degrees) agree offset for offset: the port sums
    the projected pattern's mean in its own order, so an offset near .5 may
    round the other way (ROADMAP, accepted differences, slice 6)."""
    from multicol_slam_tpu_torch.ops import brief as brief_ops

    rig, prig, f, ref, _ = frame
    lvl0 = (f.octave == 0) & f.valid
    assert int(lvl0.sum()) > 100
    assert torch.equal(f.valid & (f.octave == 0), ref["valid"] & (ref["octave"] == 0))
    assert torch.equal(f.uv[lvl0], ref["uv"][lvl0])
    agree = f.valid & ref["valid"] & (f.uv == ref["uv"]).all(-1) & (f.octave == ref["octave"])
    assert float(agree.sum()) >= 0.99 * float(ref["valid"].sum())
    for k in ("desc", "dmask"):
        same = (_bits(getattr(f, k)) == _bits(ref[k]))[agree]
        assert float(same.float().mean()) >= 0.99, k
    kept = _bits(f.dmask)[f.valid].float().mean()
    assert 0.2 < float(kept) < 0.98          # masks learned: some bits dropped, most kept
    # exact where the offsets agree
    pat = ref_md.orb.pattern(512)
    a0 = rig.pol[:, 0]
    kp = ref_md.undistort(rig.pol, rig.cde, rig.pp, f.uv)
    kp_port = brief_ops.undistort_keypoints(prig.cams.pol, prig.cams.cde, prig.cams.pp, prig.cams.pol[:, 0], f.uv)
    offsets_agree = torch.ones_like(agree)
    for delta in (0.0, ref_md.MASK_ROTATION, -ref_md.MASK_ROTATION):
        mine = ref_md.offsets(pat, kp, f.angle + delta, rig.invpol, rig.cde, rig.pp, a0)
        port = brief_ops._distorted_offsets(torch.as_tensor(pat, dtype=torch.int32), kp_port, f.angle + delta,
                                            prig.cams.invpol, prig.cams.cde, prig.cams.pp, prig.cams.pol[:, 0])
        offsets_agree &= (mine == port.long()).all(-1).all(-1)
    exact = agree & offsets_agree
    assert float(exact.sum()) >= 0.995 * float(agree.sum())
    assert torch.equal(f.desc[exact], ref["desc"][exact]) and torch.equal(f.dmask[exact], ref["dmask"][exact])
    assert torch.equal(f.angle[exact], ref["angle"][exact])


def test_masked_tracking_reference_follows_the_port(frame):
    """(c) The port's fused two-stage program with masks against the
    reference on a local map made of the frame's own features (each
    keypoint's ray pushed to a depth in [3, 12] m, with its descriptor and
    its mask), from a pose off by ~2 cm: the same inliers, and poses within
    1e-5, the float32 order of the two solvers' sums (the ORB reference's
    tolerance, benchmark/test_bm_reference.py)."""
    from multicol_slam_tpu_torch import bench
    from multicol_slam_tpu_torch.slam.tracking_kernels import track_frame_fused

    from benchmark.check import unpack

    rig, prig, f, _, _ = frame
    valid, rays, Mc = f.valid.numpy(), f.rays.numpy(), prig.Mc.numpy()
    X, D, n = bench.local_map(valid, rays, f.desc.numpy(), Mc, np.random.default_rng(0))
    _, Dm, _ = bench.local_map(valid, rays, f.dmask.numpy(), Mc, np.random.default_rng(0))
    L = 1024
    pts = bench.local_points(X, D, n, L, "cpu")._replace(
        normal=torch.zeros(L, 3), dmask=torch.tensor(np.pad(Dm, ((0, L - n), (0, 0)), constant_values=255)))
    pose0 = torch.tensor(bench.POSE0, dtype=torch.float32)
    th = 0.5 * 3.0 * SMALL["desc_size"]
    packed = track_frame_fused(prig.Mc_cayley.float(), prig.cams.to_vector(), prig.cams, f, pose0, pts, pts,
                               scale_factor=SMALL["scale_factor"], n_levels=SMALL["n_levels"], radius1=15.0,
                               radius2=4.0, th_desc=th, use_masks=True)
    prog = unpack(packed.numpy())
    feats = {k: getattr(f, k) for k in ("uv", "octave", "desc", "dmask", "valid")}
    ref = ref_track.track(rig, feats, pose0, pts._asdict(), SMALL)
    assert prog["n_inliers"] == ref["n_inliers"] > 100
    assert np.abs(prog["pose"] - ref["pose"].numpy()).max() < 1e-5
    assert np.array_equal(np.where(prog["inlier"], prog["assign"], -1),
                          np.where(ref["inlier"].numpy(), ref["assign"].numpy(), -1))
    # the masks matter: with them dropped, the plain distance at the same
    # threshold matches otherwise
    plain = ref_track.track(rig, dict(feats, dmask=torch.full_like(f.dmask, 255)), pose0,
                            dict(pts._asdict(), dmask=torch.full_like(pts.dmask, 255)), SMALL)
    assert not torch.equal(plain["assign"], ref["assign"])


# The cell cut to a CPU test: 150 features x 4 levels, 6 warm frames, one
# describe frame and one traced frame after the window, the
# keyframe cadence of 6 frames/s (keyframes as often as the 0.2-m baseline
# allows), keyframes mapped inline (the runner's sync branch: no
# worker to wait on) and a 30-s window, so that frames are sampled and a
# local BA begins inside the window even where the other test workers slow
# a frame to ~15 s. The harness pins each thread to one CPU for the card's
# measurements; here that would tie the run to cores those workers keep
# busy, so the pinning is left out.
RUN_CELL = """if True:
    import json, torch
    torch.set_num_threads(2)
    from benchmark import run as harness
    harness.pin_threads = lambda: {}
    small = {"traffic": {"mapping": "sync", "warm_frames": 6, "check_frames": 2, "check_local_ba": 1,
                         "describe_frames": 1, "trace_frames": 1},
             "config": {"settings": {"n_features": 150, "n_levels": 4, "fps": 6.0}}}
    line = harness.run_cell("mdbrief-pipeline", 2 ** 31 + 29, 30.0, True, device="cpu", overrides=small)
    print(json.dumps(line))
"""


def test_mdbrief_cell_runs_and_checks_on_the_cpu():
    """(d) The cell through the harness, in a process of its own (the
    harness sets the process's environment and threads): correct, with the
    masked check's numbers and the new host metric."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", RUN_CELL], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 2 and line["failed"] == 0
    assert list(line["checks"]) == ["kp_mismatch", "desc_mismatch", "mask_mismatch", "pose_gap", "inlier_mismatch",
                                    "failed_share", "lba_cost_gap", "lba_cost_claim_gap", "lba_pose_gap"]
    assert line["checks"]["kp_mismatch"]["value"] == 0.0 and line["checks"]["mask_mismatch"]["value"] == 0.0
    assert {"system.track_begin_ms", "features.prepare_ms", "features.describe_ms"} <= set(line["metrics"])
    # the runner's log: every K1 launch of the traced stretch masked (mapped
    # inline, fusion's launches are the tracker thread's)
    log = [s for s in res.stderr.splitlines() if s.startswith("slam_stream_masked:")]
    assert log and "'k1_tracker_masked'" in log[-1]
    counts = dict(s.split(": ") for s in log[-1].split("counters {")[1].split("}")[0].replace("'", "").split(", "))
    assert int(counts["k1_tracker"]) > 0 and counts["k1_tracker"] == counts["k1_tracker_masked"]
    assert counts["k1_worker"] == counts["k1_worker_masked"]


def test_extraction_spans_and_counters():
    """(e) With the tracer on, one `features.extract` span a frame (no
    counters of its own), and one `features.describe` child a level
    with its level, valid slots and the share of mask bits kept; off,
    nothing is recorded."""
    from multicol_slam_tpu_torch.slam.map_store import MapConfig
    from multicol_slam_tpu_torch.slam.system import MultiColSLAM
    from multicol_slam_tpu_torch.utils.config import SlamSettings

    rig = Rig(CFG["rig"], "cpu")
    img = RoomWorld(CFG["world"], rig, 2 ** 31 + 5, "cpu").frame(4)
    ex = _settings(SMALL)
    slam = MultiColSLAM(_port_rig(), SlamSettings(extractor=ex), MapConfig(n_cams=3, feats_per_cam=ex.n_features),
                        use_loop_closing=False, device="cpu")
    off = slam.prepare(img)
    assert tracing.records() == []
    tracing.enable()
    on = slam.prepare(img)
    recs = tracing.records()
    assert torch.equal(off.desc, on.desc) and torch.equal(off.dmask, on.dmask)
    ext = [r for r in recs if r.name == "features.extract"]
    assert len(ext) == 1 and not ext[0].counts
    desc = [r for r in recs if r.name == "features.describe"]
    assert [r.parent for r in desc] == [ext[0].id] * SMALL["n_levels"]
    counts = [r.read_counts() for r in desc]
    assert [c["level"] for c in counts] == list(range(SMALL["n_levels"]))
    per_level = [int(((on.octave == lvl) & on.valid).sum()) for lvl in range(SMALL["n_levels"])]
    assert [c["keypoints"] for c in counts] == per_level
    kept = _bits(on.dmask)[on.valid].float().mean()
    total = sum(c["mask_bits_kept"] * c["keypoints"] for c in counts) / sum(per_level)
    assert total == pytest.approx(float(kept), rel=1e-5) and 0.2 < total < 0.98
    assert all(r.end >= r.start for r in recs) and ext[0].start <= desc[0].start and desc[-1].end <= ext[0].end


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("name", ["mdbrief.py", "tracking_masked.py"])
def test_references_import_neither_the_port_nor_jax(name):
    """(f) The plain references import neither the program under test nor
    JAX, at any depth of the file."""
    found = _imports(ROOT / "benchmark" / "reference" / name)
    assert not found & {"multicol_slam_tpu_torch", "multicol_slam_tpu", "jax", "jaxlib", "flax"}, found
    assert "torch" in found


@pytest.mark.parametrize("metric", ["features.describe_ms", "features.describe_device_ms"])
def test_new_readers_read_none_on_an_empty_outcome(metric):
    """(f) A run with nothing to read (as a program without the spans
    leaves it) gives None, not an error; lists give their median."""
    import importlib.util

    path = ROOT / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("reader_" + metric.replace(".", "_"), path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)

    class Outcome:
        spans: dict = {}
    assert reader.read(Outcome()) is None
    run = Outcome()
    run.spans = {"features.describe": [3.0, 1.0, 2.0], "features.describe_device": [0.5, 0.25, 1.0]}
    assert reader.read(run) == (2.0 if metric == "features.describe_ms" else 0.5)
