"""Long run: the map past its initial capacity and loops over a large graph
(port of the repository's `longrun.py`, which stays the JAX package's).

An out-and-back corridor tracked with oracle features for 1600 frames at an
aggressive keyframe cadence, built to push the map toward the store's
initial 256-keyframe capacity (the store doubles past it) and the loops'
essential graph toward its matrix-free PCG branch (more than 256
keyframes, optim/ba.optimize_essential_graph); the per-frame host
bookkeeping (the tracker's local-map vote, the keyframes' point-stats
scans) is timed against the map's size, and on the return leg loops close
over the large graph. Culling is the only control of the map's size, as in
the reference (cLocalMapping.cpp:520-597), so how far the map grows is the
run's outcome: on an H100 it peaked at 238 live keyframes (PERF.md).

    python3 -m multicol_slam_tpu_torch.longrun [--frames N] [--out PATH]

The world is always the full run's, made for 1600 frames (or N, where N is
larger), and the first N frames are tracked: `--frames 200` is the full
run's first 200 frames. (The reference makes its world for N frames; a
world made for a few hundred frames packs the 6000 landmarks so densely
that the oracle features of consecutive frames barely overlap, and the map
never initializes.) Writes PATH (default LONGRUN.jsonl): one record every
25 frames and a summary line; prints each. Runs on the card;
`main([...], device="cpu")` runs on the CPU.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

from multicol_slam_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from multicol_slam_tpu_torch.io.synthetic import make_synthetic_rig, make_world
from multicol_slam_tpu_torch.models.vocab import KeyFrameDatabase, build_vocabulary
from multicol_slam_tpu_torch.slam.map_store import MapConfig
from multicol_slam_tpu_torch.slam.system import WORKING, MultiColSLAM
from multicol_slam_tpu_torch.utils.config import ExtractorSettings, SlamSettings

RECORD_EVERY = 25
FULL_RUN = 1600   # frames of the full run, which sets the world's layout


def _mean(xs):
    return round(float(np.mean(xs)), 3) if xs else 0.0


def main(argv=None, device=DEFAULT_DEVICE) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    n_frames = FULL_RUN
    out_path = "LONGRUN.jsonl"
    it = iter(argv)
    for a in it:
        if a == "--frames":
            n_frames = int(next(it))
        elif a == "--out":
            out_path = next(it)
        else:
            raise SystemExit(f"unknown arg {a}")
    device = resolve_device(device)

    world = make_world(n_points=6000, n_frames=max(FULL_RUN, n_frames), n_cams=3, n_feats=150,
                       noise_px=0.4, trajectory="outback", landmarks="corridor", max_vis_dist=5.0, seed=5)
    settings = SlamSettings(fps=7.5, extractor=ExtractorSettings(n_features=150, n_levels=1))
    cfg = MapConfig(max_keyframes=256, max_points=20000, n_cams=3, feats_per_cam=150, n_levels=1)
    slam = MultiColSLAM(make_synthetic_rig(3, device=device), settings, cfg, use_loop_closing=True, device=device)
    slam.loop_closer.voc = build_vocabulary(world.descs, k=9, depth=3, device=device)
    slam.loop_closer.db = KeyFrameDatabase(slam.loop_closer.voc)

    # the per-frame host bookkeeping (the tracker's local-map vote) and the
    # per-keyframe point-stats scan, timed where they are called
    vote_ms: list = []
    stats_ms: list = []
    orig_vote = slam._local_map_points_locked
    orig_stats = slam.store.update_point_stats_many

    def timed_vote(seed_pts):
        t0 = time.perf_counter()
        out = orig_vote(seed_pts)
        vote_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def timed_stats(ps):
        t0 = time.perf_counter()
        out = orig_stats(ps)
        stats_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    slam._local_map_points_locked = timed_vote
    slam.store.update_point_stats_many = timed_stats

    records = []
    t_start = time.time()
    max_kf = 0
    for t in range(n_frames):
        f0 = time.perf_counter()
        m = slam.track(feats=world.frame_features(t, device=device), timestamp=world.timestamps[t])
        frame_ms = (time.perf_counter() - f0) * 1e3
        max_kf = max(max_kf, int(slam.store.kf_valid.sum()))
        if t % RECORD_EVERY == RECORD_EVERY - 1:
            rec = dict(
                frame=t,
                state=m.state,
                n_kf=int(slam.store.kf_valid.sum()),
                n_pt=int(slam.store.pt_valid.sum()),
                kf_capacity=int(slam.store.cfg.max_keyframes),
                pt_capacity=int(slam.store.cfg.max_points),
                vote_ms_mean=_mean(vote_ms),
                vote_ms_max=round(float(np.max(vote_ms)), 3) if vote_ms else 0.0,
                stats_ms_mean=_mean(stats_ms),
                frame_ms=round(frame_ms, 1),
                loops=slam.loop_closer.n_loops_closed,
            )
            records.append(rec)
            vote_ms.clear()
            stats_ms.clear()
            print(json.dumps(rec), flush=True)

    tracked = sum(1 for m in slam.trajectory if m.state == WORKING)
    # the vote's cost on the largest map against the earliest maps
    early = [r for r in records if r["n_kf"] <= 64]
    late = [r for r in records if r["n_kf"] >= max(records, key=lambda r: r["n_kf"])["n_kf"] * 0.8]
    summary = dict(
        summary=True,
        n_frames=n_frames,
        tracked=tracked,
        max_keyframes_live=max_kf,
        final_kf=records[-1]["n_kf"],
        final_pt=records[-1]["n_pt"],
        kf_capacity=records[-1]["kf_capacity"],
        loops_closed=slam.loop_closer.n_loops_closed,
        loop_locked_max_ms=round(max(slam.loop_closer.locked_phase_ms, default=0.0), 2),
        vote_ms_early=round(float(np.mean([r["vote_ms_mean"] for r in early])), 3) if early else None,
        vote_ms_late=round(float(np.mean([r["vote_ms_mean"] for r in late])), 3) if late else None,
        wall_s=round(time.time() - t_start, 1),
    )
    with open(out_path, "w") as f:
        for r in records + [summary]:
            f.write(json.dumps(r) + "\n")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
