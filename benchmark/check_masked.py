"""The output check of the mdBRIEF cells: what the timed path produced,
against the plain masked references (benchmark/reference/mdbrief.py and
tracking_masked.py), as numbers that the cell's limits file bounds.

Over the sampled frames of the window (at least one; every number is inf
when none could be checked):
  kp_mismatch, desc_mismatch, pose_gap, inlier_mismatch
                     as in benchmark/check.py, against the mdBRIEF
                     extraction and the masked tracking
  mask_mismatch      share of the slots both sides agree on (validity,
                     pixel and level) whose stability masks differ in any
                     bit
The mapping worker's local BA is checked by check.local_ba, unchanged.

`control`: the references stand in the program's place, computed in the
precision below the configuration's: the extraction with TF32 matmuls, the
tracking in bfloat16 (as check.slam_frames does).
"""
from __future__ import annotations

import math

import torch

from benchmark.check import compare_features, compare_tracking, tf32, unpack
from benchmark.reference import mdbrief as ref_md
from benchmark.reference import tracking_masked as ref_track

NAMES = ("kp_mismatch", "desc_mismatch", "mask_mismatch", "pose_gap", "inlier_mismatch")


def compare_masks(prog: dict, ref: dict) -> float:
    """Share of the slots both sides agree on whose masks differ."""
    agree = prog["valid"].bool() & ref["valid"].bool() & (prog["uv"] == ref["uv"]).all(-1) & (
        prog["octave"].long() == ref["octave"].long())
    differ = (prog["dmask"] != ref["dmask"]).any(-1) & agree
    return float(differ.sum()) / max(float(agree.sum()), 1.0)


def slam_frames(samples, rig, settings: dict, control: bool = False) -> dict:
    if not samples:
        return {n: math.inf for n in NAMES}
    worst = dict.fromkeys(NAMES, 0.0)
    for s in samples:
        pose_pred = torch.as_tensor(ref_track.predict(s["last_pose"], s["velocity"]), device=s["images"].device)
        with tf32(False):
            ref_f = ref_md.extract(s["images"], settings, rig)
            ref_t = ref_track.track(rig, ref_f, pose_pred, s["pts"], settings)
        if control:
            with tf32(True):
                prog_f = ref_md.extract(s["images"], settings, rig)
            t = ref_track.track(rig, prog_f, pose_pred, s["pts"], settings, dtype=torch.bfloat16)
            prog_t = dict(pose=t["pose"].float().cpu().numpy(), assign=t["assign"].cpu().numpy(),
                          inlier=t["inlier"].cpu().numpy())
        else:
            prog_f, prog_t = s["feats"], unpack(s["packed"])
        kp, desc = compare_features(prog_f, ref_f)
        gap, inl = compare_tracking(prog_t, ref_t)
        for n, v in zip(NAMES, (kp, desc, compare_masks(prog_f, ref_f), gap, inl)):
            worst[n] = max(worst[n], v)
    return worst
