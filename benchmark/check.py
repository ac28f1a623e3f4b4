"""The output check: what the timed path produced, against the plain
references in benchmark/reference/, as numbers that the cell's limits file
bounds.

SLAM cells, over the sampled frames of the window (at least one; every
number is inf when none could be checked):
  kp_mismatch        share of the feature slots where the program's and
                     the reference's extraction disagree on validity,
                     pixel or level (of the slots valid on either side)
  desc_mismatch      share of the slots both sides agree on whose
                     descriptors differ in any bit
  pose_gap           largest difference of a component of the tracked
                     pose (Cayley and metres) after the two stages
  inlier_mismatch    rows whose (map point, inlier) outcome differs, over
                     the reference's inliers
  failed_share       frames of the window the system did not track, over
                     the frames of the window
The reference extracts from the frame's image and tracks its own features
against the program's local-map block from the program's last pose and
velocity: the map and the pose it starts from are the program's state,
which only the program's own history makes. The mapping worker's local BA
is checked apart (below), on solves of the window.

Local BA (mapping cells), over the sampled solves of the window's
keyframes, each re-solved by the reference from the same poses, points and
observations for the iterations the program ran:
  lba_cost_gap, lba_cost_claim_gap, lba_pose_gap
                  as cost_gap, cost_claim_gap and pose_gap below

BA cells, over every solve of the window:
  cost_gap        |program's final cost - reference's| / reference's
  cost_claim_gap  |program's final cost - the cost of its returned
                  parameters, evaluated by the reference| / reference's
  pose_gap        largest difference of a keyframe pose component

`control`: the reference stands in the program's place, computed in the
precision below the configuration's: the extraction with TF32 matmuls (its
pyramid's matmuls are float32 with TF32 off), the tracking and the BA in
bfloat16 (their float32 arithmetic takes no tensor-core path, so TF32
leaves it unchanged).
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from benchmark.baproblem import Problem, intrinsics
from benchmark.reference import ba as ref_ba
from benchmark.reference import orb as ref_orb
from benchmark.reference import tracking as ref_track


@contextlib.contextmanager
def tf32(on: bool):
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def unpack(packed: np.ndarray) -> dict:
    """The fused tracking program's packed result: stage 1's pose and
    inliers, then stage 2's pose, matches, inliers, assignment and inlier
    flags."""
    p = packed[7:]
    ck = (len(p) - 8) // 2
    return dict(pose1=packed[:6], n1=int(packed[6]), pose=p[:6], n_inliers=int(p[7]),
                assign=p[8:8 + ck].astype(np.int64), inlier=p[8 + ck:8 + 2 * ck] > 0.5)


def compare_features(prog: dict, ref: dict) -> tuple:
    pv, rv = prog["valid"].bool(), ref["valid"].bool()
    same_pos = (prog["uv"] == ref["uv"]).all(-1) & (prog["octave"].long() == ref["octave"].long())
    agree = pv & rv & same_pos
    either = pv | rv
    kp = float((either & ~agree).sum()) / max(float(either.sum()), 1.0)
    differ = (prog["desc"] != ref["desc"]).any(-1) & agree
    return kp, float(differ.sum()) / max(float(agree.sum()), 1.0)


def compare_tracking(prog: dict, ref: dict) -> tuple:
    gap = float(np.max(np.abs(np.asarray(prog["pose"], np.float64) - ref["pose"].double().cpu().numpy())))
    a_p = np.where(prog["inlier"], prog["assign"], -1)
    r_inl = ref["inlier"].cpu().numpy()
    a_r = np.where(r_inl, ref["assign"].cpu().numpy(), -1)
    return gap, float((a_p != a_r).sum()) / max(int(r_inl.sum()), 1)


def slam_frames(samples, rig, settings: dict, control: bool = False) -> dict:
    names = ("kp_mismatch", "desc_mismatch", "pose_gap", "inlier_mismatch")
    if not samples:
        return {n: math.inf for n in names}
    worst = dict.fromkeys(names, 0.0)
    for s in samples:
        pose_pred = torch.as_tensor(ref_track.predict(s["last_pose"], s["velocity"]), device=s["images"].device)
        with tf32(False):
            ref_f = ref_orb.extract(s["images"], settings, rig.pp, rig.wh)
            ref_t = ref_track.track(rig, ref_f, pose_pred, s["pts"], settings)
        if control:
            with tf32(True):
                prog_f = ref_orb.extract(s["images"], settings, rig.pp, rig.wh)
            t = ref_track.track(rig, prog_f, pose_pred, s["pts"], settings, dtype=torch.bfloat16)
            prog_t = dict(pose=t["pose"].float().cpu().numpy(), assign=t["assign"].cpu().numpy(),
                          inlier=t["inlier"].cpu().numpy())
        else:
            prog_f, prog_t = s["feats"], unpack(s["packed"])
        kp, desc = compare_features(prog_f, ref_f)
        gap, inl = compare_tracking(prog_t, ref_t)
        for n, v in zip(names, (kp, desc, gap, inl)):
            worst[n] = max(worst[n], v)
    return worst


def ba_solves(prob, lm: dict, solves, control: bool = False, prefix: str = "") -> dict:
    """`solves`: [(poses, points, cost)] of the program's window, each from
    `prob`'s start."""
    names = tuple(prefix + n for n in ("cost_gap", "cost_claim_gap", "pose_gap"))
    if not solves:
        return {n: math.inf for n in names}
    with tf32(False):
        poses_r, _, cost_r = ref_ba.solve(prob, lm)
    if control:
        solves = [ref_ba.solve(prob, lm, dtype=torch.bfloat16)]
    cost_r = float(cost_r)
    worst = dict.fromkeys(names, 0.0)
    for poses, points, cost in solves:
        poses, points = poses.float(), points.float()
        r, z = ref_ba.residuals(poses, points, prob.mc, prob.intr, prob.kf, prob.pt, prob.cam, prob.uv)
        claimed = float(ref_ba.robust_cost(r, z, prob.valid, float(lm["huber_delta"]), prob.inv_sigma2))
        cost = float(cost)
        vals = (abs(cost - cost_r) / cost_r, abs(cost - claimed) / cost_r,
                float((poses - poses_r).abs().max()))
        for n, v in zip(names, vals):
            worst[n] = max(worst[n], v if math.isfinite(v) else math.inf)
    return worst


def local_ba(solves, rig, spec: dict, control: bool = False) -> dict:
    """`solves`: the runner's records of local-BA solves of the window (the
    inputs, cg_iters, the iterations run, the program's result). `spec`:
    the configuration's LM constants of the local BA."""
    names = ("lba_cost_gap", "lba_cost_claim_gap", "lba_pose_gap")
    if not solves:
        return {n: math.inf for n in names}
    worst = dict.fromkeys(names, 0.0)
    for rec in solves:
        if not bool(rec["free_points"].all()):
            return {n: math.inf for n in names}
        prob = Problem(rec["poses"], rec["points"], rig.mc6, intrinsics(rig).to(rec["uv"].device), rec["kf"],
                       rec["pt"], rec["cam"], rec["uv"], rec["valid"], rec["free_poses"], rec["inv_sigma2"])
        lm = dict(spec, max_iters=rec["iters"], cg_iters=rec["cg_iters"])
        out = ba_solves(prob, lm, [(rec["out_poses"], rec["out_points"], rec["out_cost"])], control, "lba_")
        for n in names:
            worst[n] = max(worst[n], out[n])
    return worst
