"""System facade: the tracking state machine and the pipeline around it
(port of `multicol_slam_tpu/slam/system.py`).

Per frame (cSystem + cTracking, cTracking.cpp:237): extract -> (bootstrap |
the fused two-stage tracking program) -> keyframe decision. After each
keyframe slam/local_mapping.py extends the map, then (with
`use_loop_closing`, the default) slam/loop_closing.py looks for a loop and
closes it. A LOST frame relocalizes against candidates retrieved from the
BoW keyframe database (before the loop closer has a vocabulary: the last
keyframe's covisible neighbourhood).

Two pipelines. Sync mode (`async_mapping=False`) maps each keyframe inline
and is deterministic. Async mode (the CLI's default; the reference's
threads 2 and 3, cSystem.cpp:98-102) hands keyframes after the first five
to a worker thread that runs local mapping and loop closing; on the card
the worker launches on a CUDA stream of its own. The tracker and the
worker share the host map store under `map_lock`, held only for store
bookkeeping and commits. The worker yields to the tracker before each
device launch: it spends credits, two earned a finished frame up to six,
with bounded waits. The worker draws its RANSAC hypotheses from a
generator of its own. Its exceptions are printed and kept in
`worker_errors`. Async runs are not deterministic.

States: NO_IMAGES_YET -> NOT_INITIALIZED -> INITIALIZING -> WORKING <-> LOST
(cTracking.h:79-87).

With mdBRIEF's learned masks (`extractor.use_mdbrief` and `learn_masks`)
every matcher takes the masked Hamming distance at x0.5 thresholds: both
tracking stages, the bootstrap's window match, triangulation and fusion,
relocalization and the loop's Sim3 candidates (`use_masks`).

A map saved with `save_checkpoint` (io/checkpoint.py) is resumed with
`resume(load_map(path))`; localization mode (`activate_localization_mode`)
tracks against the map without inserting keyframes, so nothing maps or
closes loops. Neither a resumed nor a frozen map is auto-reset when lost.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import queue
import threading
import time
import traceback
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch

from multicol_slam_tpu_torch import native
from multicol_slam_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from multicol_slam_tpu_torch.io.checkpoint import save_map
from multicol_slam_tpu_torch.io.trajectory import save_lafida_trajectory
from multicol_slam_tpu_torch.models.rig import MultiCamRig
from multicol_slam_tpu_torch.models.vocab import bow_vector, transform_words
from multicol_slam_tpu_torch.ops.best_match import masked_best_match_cams
from multicol_slam_tpu_torch.ops.fast import level_quota
from multicol_slam_tpu_torch.ops.matching import hamming_matrix, hamming_matrix_masked
from multicol_slam_tpu_torch.ops.ransac import ransac_noncentral_pose, refine_noncentral_pose, sample_weighted
from multicol_slam_tpu_torch.optim.ba import bundle_adjust
from multicol_slam_tpu_torch.slam.features import (
    ExtractorTables, FrameFeatures, downselect_features, extract_features,
)
from multicol_slam_tpu_torch.slam.initializer import (
    _mt2_of_scale, bootstrap, calibrate_metric_scale, points_to_world,
)
from multicol_slam_tpu_torch.slam.local_mapping import LocalMapper, _NullLock
from multicol_slam_tpu_torch.slam.loop_closing import LoopCloser
from multicol_slam_tpu_torch.slam.map_store import (
    BAD_ID, MapConfig, MapStore, cayley_to_hom_np, hom_to_cayley_np,
)
from multicol_slam_tpu_torch.slam.tracking_kernels import (
    LocalPoints, track_frame_fused, track_stage, unpack_fused,
)
from multicol_slam_tpu_torch.utils.config import SlamSettings
from multicol_slam_tpu_torch.utils import tracing
from multicol_slam_tpu_torch.utils.geometry import hom_to_cayley

# tracking states (cTracking.h:79-87)
NO_IMAGES_YET = 0
NOT_INITIALIZED = 1
INITIALIZING = 2
WORKING = 3
LOST = 4

MIN_INIT_KPS = 100        # cTracking.cpp:383
MIN_TRACK_INLIERS = 15    # cTracking.cpp:881-886
MIN_POSE_INLIERS = 6      # after the pose-only stages (:794)
KF_MIN_INLIERS = 25       # c2 gate (:914-928)
KF_REF_RATIO = 0.9
STAGE2_CAP = 4096         # most local-map points a tracking stage takes


@dataclasses.dataclass
class _FrameHandle:
    """A frame between track_begin and track_finish: the fused tracking
    program's packed result and the host state its consumption needs."""

    feats: FrameFeatures
    timestamp: float
    m: "FrameMetrics"
    done: bool = False            # finished inside begin (bootstrap states)
    packed: Optional[torch.Tensor] = None
    lp2: Optional[LocalPoints] = None
    pt_ids2: Optional[np.ndarray] = None
    begin_ms: float = 0.0
    epoch: int = 0                # the store's generation; a stale handle is dropped


@dataclasses.dataclass
class FrameMetrics:
    frame_id: int
    timestamp: float
    state: int
    pose: np.ndarray
    n_matches: int = 0
    n_inliers: int = 0
    track_ms: float = 0.0
    is_keyframe: bool = False
    # the pose relative to the reference keyframe at track time: the saved
    # trajectory composes it with the keyframe's FINAL pose (the reference
    # writes keyframe poses at shutdown, cSystem.cpp:260-290)
    ref_kf: int = -1
    ref_kf_frame: int = -1     # identity check: keyframe slots are recycled
    rel_pose: Optional[np.ndarray] = None  # cayley6 of M_ref^-1 M_frame


class MultiColSLAM:
    """The cSystem equivalent: construct once, call `track` per frame.

    `device`: where the pipeline runs (the card unless device="cpu"); the
    rig must lie there. `init_sampler(frame_id, cam, n) -> [256, 8]`,
    `reloc_sampler(frame_id, n) -> [160, 6]` and `sim3_sampler(kf_frame_id,
    n) -> [300, 3]` give the RANSAC hypotheses of a bootstrap attempt, of a
    relocalization and of a loop's Sim3 (default: drawn from a CPU
    torch.Generator seeded with `seed`, so that the card draws what the CPU
    draws; the async worker's loop closer has a generator of its own,
    seeded with `seed` too). `match_fn` is the
    best-match kernel's wrapper, or its plain version to compare against."""

    # async: an insertion waits for the worker once it has cut this many
    # keyframes in a row short (`_wait_for_mapper`); with 1 at most every
    # other keyframe goes unrefined
    KF_CUT_WAIT = 1

    def __init__(
        self,
        rig: MultiCamRig,
        settings: SlamSettings,
        map_cfg: Optional[MapConfig] = None,
        use_loop_closing: bool = True,
        seed: int = 0,
        async_mapping: bool = False,
        device=DEFAULT_DEVICE,
        init_sampler: Optional[Callable] = None,
        reloc_sampler: Optional[Callable] = None,
        match_fn: Callable = masked_best_match_cams,
        sim3_sampler: Optional[Callable] = None,
    ):
        self.device = resolve_device(device)
        if rig.Mc.device.type != self.device.type:
            raise ValueError(f"the rig lies on {rig.Mc.device}, the system runs on {self.device}")
        self.rig = rig
        self.settings = settings
        ex = settings.extractor
        self.map_cfg = map_cfg or MapConfig(n_cams=rig.n_cams, feats_per_cam=ex.n_features,
                                            n_levels=ex.n_levels, scale_factor=ex.scale_factor,
                                            desc_bytes=ex.desc_size)
        # mdBRIEF stability masks: every matcher takes the masked distance,
        # at half the thresholds
        self.use_masks = bool(ex.use_mdbrief and ex.learn_masks)
        th_scale = 0.5 if self.use_masks else 1.0
        self.th_track = 3.0 * self.map_cfg.desc_bytes * th_scale   # TH_HIGH
        self.th_low = 2.0 * self.map_cfg.desc_bytes * th_scale     # TH_LOW
        self.match_fn = match_fn
        self.init_sampler = init_sampler
        self.reloc_sampler = reloc_sampler
        self.sim3_sampler = sim3_sampler
        # the RANSAC hypotheses come from a CPU generator whatever the device:
        # a CUDA generator of the same seed draws another stream (Philox, not
        # the CPU's Mersenne Twister), and the card's runs would then part
        # from the CPU's (as the reference's draws do not: threefry is the
        # same on every device)
        self.generator = torch.Generator().manual_seed(seed)
        self.seed = seed
        self.async_mapping = async_mapping
        self.map_lock = tracing.TracedLock() if async_mapping else _NullLock()
        self.use_loop_closing = use_loop_closing
        self.mc6 = rig.Mc_cayley.to(torch.float32)
        self.intr = rig.cams.to_vector()
        self._tables: Optional[ExtractorTables] = None
        self.state = NO_IMAGES_YET
        self.frame_id = -1
        self.last_pose = np.zeros(6, np.float32)
        # the motion that carries last_pose to the next frame to begin
        self.velocity = np.eye(4, dtype=np.float32)
        self._finished = deque(maxlen=4)   # (frame id, Mt) of the last tracked frames
        self.ref_feats: Optional[FrameFeatures] = None
        self.last_feats: Optional[FrameFeatures] = None
        self.last_assign_global: Optional[np.ndarray] = None  # feature -> global point id
        self.last_kf_id = -1
        self.frames_since_kf = 0
        self.ref_kf_tracked = 0
        self.ref_kf_id = -1          # mpReferenceKF (max-vote local keyframe)
        self._last_reloc_frame = -(10 ** 9)  # mnLastRelocFrameId
        self._truncated_local_pts = 0  # local-map points dropped at STAGE2_CAP
        self._interrupt_ba = False     # InterruptBA request (cLocalMapping.cpp:515)
        # insertions that passed the gates but were deferred: the mapper was busy
        self._kf_deferred_busy = 0
        # async: the worker's last keyframes in a row whose fusion or BA an
        # interruption cut short, and the insertions that waited for it
        self._kf_cut = 0
        self._kf_waited = 0
        self._tracker_waiting = False
        self._force_reloc = False
        # localization mode: track against the map without changing it
        self.localization_only = False
        # set on a map loaded from a checkpoint: a lost frame never auto-resets it
        self.map_resumed = False
        self.trajectory: List[FrameMetrics] = []
        self.worker_errors: List[BaseException] = []
        self._kf_queue: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._map_stream = None
        self._frame_idle: Optional[threading.Event] = None
        self._tracker_tid: Optional[int] = None
        self._n_inflight = 0
        self._epoch = 0
        if async_mapping:
            self._kf_queue = queue.Queue()
            # the tracker-priority gate: the worker waits for a frame edge
            # and spends a dispatch credit before each device launch
            self._frame_idle = threading.Event()
            self._frame_idle.set()
            self._budget = 0
            self._budget_cv = threading.Condition()
            if self.device.type == "cuda":
                self._map_stream = torch.cuda.Stream(device=self.device)
        self._attach_store(MapStore(self.map_cfg))
        if async_mapping:
            self._worker = threading.Thread(target=self._mapping_worker, name="mcslam-mapping", daemon=True)
            self._worker.start()

    def _attach_store(self, store: MapStore, voc=None):
        """Put `store` in place with a new LocalMapper and (with loop
        closing) a new LoopCloser on it, the loop closer keeping `voc`; in
        async mode both wired to the worker (reset and resume share it)."""
        self.store = store
        self.mapper = LocalMapper(store, self.rig, match_fn=self.match_fn, lock=self.map_lock,
                                  use_masks=self.use_masks)
        self.loop_closer: Optional[LoopCloser] = None
        if self.use_loop_closing:
            # the async worker draws from a generator of its own: one
            # generator a thread, so no draw depends on the threads' timing
            gen = torch.Generator().manual_seed(self.seed) if self.async_mapping else self.generator
            self.loop_closer = LoopCloser(store, self.rig, voc=voc, match_fn=self.match_fn,
                                          sim3_sampler=self.sim3_sampler, generator=gen, lock=self.map_lock,
                                          use_masks=self.use_masks)
        if self.async_mapping:
            self._wire_worker()

    def _wire_worker(self):
        """Async mode: the tracker-priority gate on the mapper and the loop
        closer, and (on the card) the worker's stream made to wait for the
        tensors they hold, which this thread's stream built."""
        self.mapper.yield_gate = self._yield_to_tracker
        if self.loop_closer is not None:
            self.loop_closer.yield_gate = self._yield_to_tracker
        if self._map_stream is not None:
            self._map_stream.wait_stream(torch.cuda.current_stream(self.device))
            held = [self.mapper.mc6, self.mapper.intr]
            if self.loop_closer is not None:
                held += [self.loop_closer.mc6, self.loop_closer.intr]
            for t in held:
                t.record_stream(self._map_stream)

    # ------------------------------------------------------------------
    def prepare(self, images) -> FrameFeatures:
        """Feature extraction of a frame, to pass to track(feats=...)."""
        return self._extract(images)

    def _extract(self, images) -> FrameFeatures:
        """Extraction with the state's bank: while bootstrapping, the init
        bank (2x features at FAST threshold 5, cTracking.cpp:152-158), then
        the runtime bank."""
        ex = self.settings.extractor
        images = torch.as_tensor(images, device=self.device)
        if self._tables is None:
            self._tables = ExtractorTables(ex, images.shape[1], images.shape[2], device=self.device)
        init_bank = self.state in (NO_IMAGES_YET, NOT_INITIALIZED, INITIALIZING)
        with tracing.span("features.extract"):
            bank = dict(n_features=2 * ex.n_features, fast_th=5.0) if init_bank else {}
            return extract_features(images, self.rig.cams, ex, self._tables, **bank)

    def _level_quotas(self) -> np.ndarray:
        """Per-level slot budgets of the RUNTIME bank (kept by the init-bank
        downselect so coarse levels are never starved)."""
        ex = self.settings.extractor
        return level_quota(ex.n_features, ex.n_levels, ex.scale_factor)

    def track(self, images=None, feats: Optional[FrameFeatures] = None, timestamp: float = 0.0) -> FrameMetrics:
        """TrackMultiColSLAM (cSystem.cpp:182) + cTracking::Track (:237):
        raw images [C, H, W] uint8, or the frame's FrameFeatures (the oracle
        path of the tests)."""
        return self.track_finish(self.track_begin(images=images, feats=feats, timestamp=timestamp))

    def track_begin(self, images=None, feats: Optional[FrameFeatures] = None,
                    timestamp: float = 0.0) -> _FrameHandle:
        """First half of a frame: extraction, the bootstrap states inline,
        or the fused tracking program's dispatch (no host sync). Frames in
        flight are finished in the order they began."""
        self._n_inflight += 1
        self.frame_id += 1
        with tracing.span("system.track_begin", "frame", self.frame_id):
            t0 = time.perf_counter()
            if self._frame_idle is not None:
                self._tracker_tid = threading.get_ident()
                self._frame_idle.clear()
            try:
                if feats is None:
                    feats = self._extract(images)
                if self.state in (WORKING, LOST) and feats.valid.shape[1] != self.map_cfg.feats_per_cam:
                    # extracted with the init bank before the state advanced
                    feats, _ = downselect_features(feats, self.map_cfg.feats_per_cam, quotas=self._level_quotas())
                m = FrameMetrics(self.frame_id, timestamp, self.state, self.last_pose.copy())
                h = _FrameHandle(feats=feats, timestamp=timestamp, m=m, epoch=self._epoch)
                if self.state in (NO_IMAGES_YET, NOT_INITIALIZED):
                    if int(feats.valid.sum()) > MIN_INIT_KPS:
                        self.ref_feats = feats
                        self.state = INITIALIZING
                    else:
                        self.state = NOT_INITIALIZED
                    h.done = True
                elif self.state == INITIALIZING:
                    self._try_initialize(feats, timestamp)
                    h.done = True
                else:
                    self._track_frame_begin(h)
                h.begin_ms = (time.perf_counter() - t0) * 1e3
                return h
            finally:
                if self._frame_idle is not None:
                    self._frame_idle.set()

    def track_finish(self, h: _FrameHandle) -> FrameMetrics:
        """Second half: read the packed result back, the fallback paths, the
        bookkeeping and the keyframe decision. In async mode each finished
        frame gives the worker two dispatch credits (at most six banked)."""
        with tracing.span("system.track_finish", "frame", h.m.frame_id):
            t0 = time.perf_counter()
            self._n_inflight -= 1
            m = h.m
            if h.epoch != self._epoch:
                h.done = True  # the map was reset while this frame was in flight
            if self._frame_idle is not None:
                self._frame_idle.clear()
            try:
                if not h.done:
                    self._track_frame_finish(h)
            finally:
                if self._frame_idle is not None:
                    self._frame_idle.set()
                    with self._budget_cv:
                        self._budget = min(self._budget + 2, 6)
                        self._budget_cv.notify()
            self.last_feats = h.feats
            m.state = self.state
            m.pose = self.last_pose.copy()
            if self.state == WORKING:
                self._record_anchor(m)
            m.track_ms = h.begin_ms + (time.perf_counter() - t0) * 1e3
            self.trajectory.append(m)
            return m

    def _record_anchor(self, m: FrameMetrics):
        """Anchor the frame's pose to its reference keyframe, so that
        save_trajectory composes it with the keyframe's final pose."""
        s = self.store
        rk = self.ref_kf_id
        if rk < 0:
            return
        with self.map_lock:
            if not s.kf_valid[rk]:
                return
            ref_pose = s.kf_pose[rk].copy()
            m.ref_kf_frame = int(s.kf_frame_id[rk])
        m.ref_kf = int(rk)
        m.rel_pose = hom_to_cayley_np(np.linalg.inv(cayley_to_hom_np(ref_pose)) @ cayley_to_hom_np(m.pose))

    def _yield_to_tracker(self):
        """The worker's gate before each device launch: wait (at most 0.2 s)
        for a dispatch credit and spend it, then wait (at most 0.05 s) for
        the tracker to be between frames. A no-op on the tracker's own
        thread (its synchronous mapping of the first keyframes)."""
        if self._frame_idle is None or threading.get_ident() == self._tracker_tid or self._tracker_waiting:
            return
        with self._budget_cv:
            if self._budget <= 0:
                self._budget_cv.wait(timeout=0.2)
            self._budget = max(self._budget - 1, 0)
        self._frame_idle.wait(timeout=0.05)

    # ------------------------------------------------------------------
    def _try_initialize(self, feats: FrameFeatures, timestamp: float):
        if feats.valid.shape[1] != self.ref_feats.valid.shape[1]:
            # the reference frame was extracted with the runtime bank before a
            # reset (a prefetched frame): this frame of the init bank replaces
            # it (the reference's bootstrap fails on the two shapes)
            self.ref_feats = feats
            return
        sampler = None
        if self.init_sampler is not None:
            fid = self.frame_id
            sampler = lambda cam, n: self.init_sampler(fid, cam, n)  # noqa: E731
        res, n_matches = bootstrap(self.rig, self.ref_feats, feats, sampler=sampler,
                                   generator=self.generator, use_masks=self.use_masks, match_fn=self.match_fn)
        if res is None:
            # baseline too small: KEEP the reference so parallax accumulates;
            # re-snapshot only when the overlap collapses
            if n_matches < 100 and int(feats.valid.sum()) > MIN_INIT_KPS:
                self.ref_feats = feats
            return
        # the metric scale from the rig's baseline before committing the map
        scale, _ = calibrate_metric_scale(self.rig, self.ref_feats, feats, res)
        if scale != 1.0:
            Mc = self.rig.Mc[res.leading_cam].cpu().numpy().astype(np.float64)
            T21 = np.linalg.inv(np.linalg.inv(Mc) @ np.asarray(res.Mt2) @ Mc)
            res = res._replace(points_cam=res.points_cam * scale,
                               Mt2=_mt2_of_scale(self.rig, res.leading_cam, T21[:3, :3], T21[:3, 3], scale))
        # init-bank downselect to the runtime capacity: triangulated features
        # whose response also clears the runtime FAST threshold first
        feat1 = np.asarray(res.feat1, np.int64)
        feat2 = np.asarray(res.feat2, np.int64)
        Xw = points_to_world(self.rig, res.leading_cam, res.points_cam)
        Kc = self.map_cfg.feats_per_cam
        if self.ref_feats.valid.shape[1] != Kc or feats.valid.shape[1] != Kc:
            th_run = float(self.settings.extractor.fast_th)
            r1 = self.ref_feats.response.reshape(-1).cpu().numpy()
            r2 = feats.response.reshape(-1).cpu().numpy()
            strong = (r1[feat1] >= th_run) & (r2[feat2] >= th_run)
            quotas = self._level_quotas()
            self.ref_feats, remap1 = downselect_features(self.ref_feats, Kc, keep=feat1[strong], quotas=quotas)
            feats, remap2 = downselect_features(feats, Kc, keep=feat2[strong], quotas=quotas)
            feat1 = remap1[feat1]
            feat2 = remap2[feat2]
            sel = (feat1 >= 0) & (feat2 >= 0) & strong
            feat1, feat2, Xw = feat1[sel], feat2[sel], Xw[sel]
        s = self.store
        k1 = s.add_keyframe(np.zeros(6, np.float32), self.ref_feats, timestamp, self.frame_id - 1)
        pose2 = hom_to_cayley(torch.tensor(np.asarray(res.Mt2), dtype=torch.float32)).numpy()
        k2 = s.add_keyframe(pose2, feats, timestamp, self.frame_id)
        new_ids = []
        for i in range(len(Xw)):
            f1, f2 = int(feat1[i]), int(feat2[i])
            p = s.add_point(Xw[i].astype(np.float32), s.kf_desc[k1, f1], s.kf_dmask[k1, f1], first_kf=k1,
                            normal=np.zeros(3, np.float32), min_dist=0.1, max_dist=25.0)
            s.add_observation(k1, f1, p)
            s.add_observation(k2, f2, p)
            new_ids.append(p)
        s.update_point_stats_many(np.asarray(new_ids))
        # the reference's order (cTracking.cpp:513-701): cross-camera
        # re-observation first, then global BA with only the first pose fixed
        self.mapper.fuse_neighbors(k2)
        self._global_ba()
        self.mapper.run(k2, do_ba=False)
        self.last_pose = s.kf_pose[k2].copy()
        self.velocity = np.eye(4, dtype=np.float32)
        self._finished.clear()
        self.last_kf_id = k2
        self.frames_since_kf = 0
        self.last_assign_global = s.kf_point[k2].copy()
        self.ref_kf_tracked = int((s.kf_point[k2] >= 0).sum())
        self.ref_kf_id = k2
        self.state = WORKING

    # ------------------------------------------------------------------
    def _gather_points(self, pt_ids: np.ndarray, cap: int):
        """The points' LocalPoints block on the device (at most `cap`; the
        drops are counted and the first few logged) and the ids it holds."""
        with tracing.span("track.gather"):
            s = self.store
            n = min(len(pt_ids), cap)
            if n < len(pt_ids):
                self._truncated_local_pts += len(pt_ids) - n
                if self._truncated_local_pts <= 3 * (len(pt_ids) - n):
                    print(f"[multicol-slam] local-map gather truncated {len(pt_ids) - n} of "
                          f"{len(pt_ids)} points (cap {cap})")
            pt_ids = pt_ids[:n]
            with self.map_lock:
                host = (s.pt_X[pt_ids], s.pt_desc[pt_ids], s.pt_min_dist[pt_ids], s.pt_max_dist[pt_ids],
                        s.pt_normal[pt_ids], s.pt_dmask[pt_ids] if self.use_masks else None)

            def put(a):
                return None if a is None else torch.as_tensor(np.ascontiguousarray(a), device=self.device)
            X, desc, min_dist, max_dist, normal, dmask = (put(a) for a in host)
            return LocalPoints(X=X, desc=desc, min_dist=min_dist, max_dist=max_dist,
                               valid=torch.ones(n, dtype=torch.bool, device=self.device), normal=normal,
                               dmask=dmask), pt_ids

    def _track_frame_begin(self, h: _FrameHandle):
        """Host prep and dispatch of the fused two-stage tracking program
        (motion-model stage + local-map stage, one packed result). A forced
        relocalization runs first; when it fails the frame ends LOST."""
        s = self.store
        if self._force_reloc:
            # ForceRelocalisation (cTracking.cpp:1340-1351): the pose comes
            # from relocalization before tracking
            self._force_reloc = False
            if self._relocalize(h.feats, h.m, forced=True):
                self.state = WORKING
            else:
                self.state = LOST
                h.done = True
                return
        pose_pred = self.last_pose
        if self.settings.use_motion_model:
            pose_pred = hom_to_cayley_np(cayley_to_hom_np(self.last_pose) @ self.velocity)
        prev = self.last_assign_global
        pt_ids = np.unique(prev[prev >= 0]) if prev is not None else np.empty(0, np.int64)
        pt_ids = pt_ids[s.pt_valid[pt_ids]] if len(pt_ids) else pt_ids
        local_pts = self._local_map_points(pt_ids)
        if len(local_pts) < 10:
            return    # no candidates: LOST in finish
        # one gathered local-map block serves both stages
        lp2, pt_ids2 = self._gather_points(local_pts, STAGE2_CAP)
        ex = self.settings.extractor
        h.packed = track_frame_fused(
            self.mc6, self.intr, self.rig.cams, h.feats,
            torch.as_tensor(pose_pred, dtype=torch.float32, device=self.device), lp2, lp2,
            scale_factor=ex.scale_factor, n_levels=ex.n_levels, radius1=15.0, radius2=4.0,
            th_desc=self.th_track, min_pose_inliers=MIN_POSE_INLIERS, use_masks=self.use_masks,
            match_fn=self.match_fn)
        h.lp2, h.pt_ids2 = lp2, pt_ids2

    def _track_frame_finish(self, h: _FrameHandle):
        s = self.store
        feats, m = h.feats, h.m
        ex = self.settings.extractor
        n_inl = 0
        ok = False
        assign_global = np.full(s.cfg.feats_per_kf, BAD_ID, np.int32)
        if h.packed is not None:
            with tracing.span("track.readback"):
                packed = h.packed.cpu().numpy()
            _, n1, pose_f2, n_match2, n_inl, assign, inl = unpack_fused(packed)
            if n_inl < MIN_TRACK_INLIERS and n1 < MIN_POSE_INLIERS:
                # TrackPreviousFrame's coarse -> fine protocol (cTracking.cpp:
                # 731-795): wide windows from the UNADVANCED last pose
                packed = track_frame_fused(
                    self.mc6, self.intr, self.rig.cams, feats,
                    torch.as_tensor(self.last_pose, dtype=torch.float32, device=self.device), h.lp2, h.lp2,
                    scale_factor=ex.scale_factor, n_levels=ex.n_levels, radius1=60.0, radius2=40.0,
                    th_desc=self.th_track, min_pose_inliers=MIN_POSE_INLIERS, use_masks=self.use_masks,
                    match_fn=self.match_fn)
                _, _, pose_f2, n_match2, n_inl, assign, inl = unpack_fused(packed.cpu().numpy())
            ok = n_inl >= MIN_TRACK_INLIERS
        if ok:
            self._finish_frame(pose_f2, m.frame_id)
            matched = (assign >= 0) & inl
            assign_global[matched] = h.pt_ids2[assign[matched]]
            with self.map_lock:       # mnVisible / mnFound
                s.pt_visible[h.pt_ids2] += 1
                s.pt_found[np.unique(assign_global[assign_global >= 0])] += 1
            m.n_matches = n_match2
            m.n_inliers = n_inl
            self.state = WORKING
        else:
            self.state = LOST
        self.last_assign_global = assign_global
        # lost: auto-reset a young map (cTracking.cpp:322-329), else
        # relocalize; a resumed or frozen map is never wiped
        if self.state == LOST:
            if s.kf_valid.sum() <= 3 and not (self.map_resumed or self.localization_only):
                self.reset()
            elif self._relocalize(feats, m):
                self.state = WORKING
            return
        # keyframe decision (NeedNewKeyFrame, cTracking.cpp:897-946)
        self.frames_since_kf += 1
        if self.localization_only:
            return
        # no insertion within maxFrames of a relocalization (:904-905)
        if (self.frame_id < self._last_reloc_frame + self.settings.max_frames
                and int(s.kf_valid.sum()) > self.settings.max_frames):
            return
        # the mapper accepts keyframes (AcceptMultiKeyFrames) with a backlog
        # of at most one; the sequential mapper is always idle
        mapper_idle = self._kf_queue is None or self._kf_queue.qsize() <= 1
        # no insertion while a loop correction commits (:899-901)
        if self.loop_closer is not None and self.loop_closer.loop_correcting:
            return
        c1a = self.frames_since_kf >= self.settings.max_frames
        c1b = self.frames_since_kf >= self.settings.min_frames and mapper_idle
        c2 = (n_inl < KF_REF_RATIO * max(self.ref_kf_tracked, 1)) and n_inl > KF_MIN_INLIERS
        # curBaseline2MKF (:876-877, :928): farther than 0.2 from the
        # reference keyframe
        baseline = 0.0
        if self.ref_kf_id >= 0:
            with self.map_lock:
                ref_pose = s.kf_pose[self.ref_kf_id].copy()
            baseline = float(np.linalg.norm(cayley_to_hom_np(self.last_pose)[:3, 3]
                                            - cayley_to_hom_np(ref_pose)[:3, 3]))
        if (c1a or c1b) and c2 and baseline > 0.2:
            if self._kf_queue is not None and self._kf_cut >= self.KF_CUT_WAIT:
                self._wait_for_mapper()
                mapper_idle = True
            if mapper_idle:
                self._create_keyframe(feats, h.timestamp, assign_global, m.frame_id)
                m.is_keyframe = True
            else:
                # InterruptBA, but no insertion yet (:933-940)
                self._interrupt_ba = True
                self._kf_deferred_busy += 1

    def _wait_for_mapper(self):
        """Back-pressure on the tracker: the worker cut its last KF_CUT_WAIT
        keyframes short (a newer keyframe or the tracker's request stopped
        their fusion or BA), so before the next insertion the tracker waits,
        with the worker's gate open, until the worker has mapped (and passed
        to the loop closer) what it holds; nothing new is queued meanwhile,
        so that keyframe is mapped whole. A tracker faster than the worker
        otherwise cuts every keyframe short and outruns its map."""
        self._kf_waited += 1
        self._tracker_waiting = True
        self._frame_idle.set()
        with self._budget_cv:
            self._budget_cv.notify_all()
        try:
            self._kf_queue.join()
        finally:
            self._tracker_waiting = False
            self._frame_idle.clear()

    def _finish_frame(self, new_pose: np.ndarray, frame_id: int):
        """The motion model: constant velocity over the k frames from this one
        to the next to begin (k = 1 + the frames still in flight), measured
        from the tracked frame k back, else over one frame. With a frame in
        flight a pipelined loop then predicts frame t + 1 from its own chain
        (t - 1 and t - 3). The one-frame velocity (t - 2 to t - 1) made the
        prediction error 2 e(t-1) - e(t-2): the two chains fed each other,
        and the mode alternating between them grew once the solve left more
        than a third of it."""
        Mt_new = cayley_to_hom_np(new_pose)
        k = self._n_inflight + 1
        back = [Mt for f, Mt in self._finished if f == frame_id - k] if k > 1 else []
        Mt_ref = back[0] if back else cayley_to_hom_np(self.last_pose)
        self.velocity = (np.linalg.inv(Mt_ref) @ Mt_new).astype(np.float32)
        self._finished.append((frame_id, Mt_new))
        self.last_pose = np.asarray(new_pose, np.float32)

    def _local_map_points(self, seed_pts: np.ndarray) -> np.ndarray:
        """UpdateReferenceKeyFrames + local points (cTracking.cpp:961-1130):
        the keyframes that observe the tracked points (by vote), plus their
        best covisible neighbours; the local map is all their points."""
        with self.map_lock:
            return self._local_map_points_locked(seed_pts)

    def _local_map_points_locked(self, seed_pts: np.ndarray) -> np.ndarray:
        with tracing.span("track.local_map"):
            s = self.store
            if len(seed_pts) == 0:
                ks = s.active_kfs()[-5:]
            else:
                votes = native.vote_counts(s.kf_point, s.kf_valid, seed_pts, s.cfg.max_points)
                ks = np.nonzero(votes > 4)[0]
                if len(ks) == 0:
                    ks = np.argsort(-votes)[:3]
                ref = int(ks[np.argmax(votes[ks])])
                self.ref_kf_id = ref
                self.ref_kf_tracked = int((s.kf_point[ref] >= 0).sum())
                neighbors = set()
                for k in ks[:10]:
                    neighbors.update(s.best_covisible(int(k), 5))
                if neighbors:
                    ks = np.unique(np.concatenate([ks, np.asarray(sorted(neighbors), np.int64)]))
            pts = s.kf_point[ks[s.kf_valid[ks]]] if len(ks) else np.empty((0,), np.int64)
            pts = np.unique(pts[pts >= 0]) if len(pts) else np.empty(0, np.int64)
            return pts[s.pt_valid[pts]] if len(pts) else pts

    def _create_keyframe(self, feats: FrameFeatures, timestamp: float, assign_global: np.ndarray,
                         frame_id: int):
        s = self.store
        with self.map_lock:
            k = s.add_keyframe(self.last_pose, feats, timestamp, frame_id)
            for f in np.nonzero(assign_global >= 0)[0]:
                s.add_observation(k, int(f), int(assign_global[f]))
            self.last_assign_global = s.kf_point[k].copy()
            self.last_kf_id = k
            self.frames_since_kf = 0
            self.ref_kf_id = k
            self.ref_kf_tracked = int((s.kf_point[k] >= 0).sum())
        if self.async_mapping and int(s.kf_valid.sum()) > 5:
            # past the first five keyframes (a young map must extend within a
            # frame or two or tracking dies, so those are mapped here), the
            # worker maps them (InsertMultiKeyFrame, cLocalMapping.cpp:131-137)
            # and their refinements reach the tracker through the store
            self._kf_queue.put(k)
            return
        self.mapper.run(k)
        # local BA may have moved the pose
        self.last_pose = s.kf_pose[k].copy()
        self.last_assign_global = s.kf_point[k].copy()
        if not self.async_mapping and self.loop_closer is not None and self.loop_closer.process(k):
            # the loop correction moved the keyframe
            self.last_pose = s.kf_pose[k].copy()

    def _mapping_worker(self):
        """The async worker (the reference's threads 2 and 3, cSystem.cpp:
        98-102, in one): local mapping of each queued keyframe, then the loop
        closer on it; on the card under its own CUDA stream. BA is deferred
        while a newer keyframe waits or the tracker asked for an insertion.
        An exception is printed and kept in `worker_errors`, and the worker
        goes on with the next keyframe."""
        stream = (torch.cuda.stream(self._map_stream) if self._map_stream is not None
                  else contextlib.nullcontext())
        with stream:
            while True:
                k = self._kf_queue.get()
                if k is None:
                    self._kf_queue.task_done()
                    return
                try:
                    self._interrupt_ba = False
                    cut = []

                    def interrupt():
                        stop = self._interrupt_ba or not self._kf_queue.empty()
                        if stop:
                            cut.append(k)
                        return stop
                    with tracing.span("map.keyframe", "keyframe", k, cpu=True):
                        self.mapper.run(k, interrupt=interrupt)
                    self._kf_cut = self._kf_cut + 1 if cut else 0
                    if self.loop_closer is not None:
                        with tracing.span("loop.process", "keyframe", k, cpu=True):
                            closed = self.loop_closer.process(k)
                        if closed:
                            # ForceRelocalisation after a loop correction
                            # (cLoopClosing.cpp:643): the tracker's pose predates it
                            self._force_reloc = True
                except Exception as e:  # noqa: BLE001 - the reference prints and carries on
                    traceback.print_exc()
                    self.worker_errors.append(e)
                finally:
                    self._kf_queue.task_done()

    # ------------------------------------------------------------------
    def _relocalize(self, feats: FrameFeatures, m: FrameMetrics, forced: bool = False) -> bool:
        """Relocalisation (cTracking.cpp:1138-1338). Candidates: the 5 best
        groups that the BoW database retrieves for the frame
        (DetectRelocalisationCandidates, cMultiKeyFrameDatabase.cpp:223-339);
        when forced (after a loop correction, :1152-1160) or without a
        vocabulary yet, the last keyframe and its 5 best covisible ones;
        failing those, the last 5 keyframes. For each: descriptor matches to
        its map points (>= 15), non-central absolute-pose RANSAC (>= 10
        inliers), the weighted refit, and a confirming tracking stage
        against the local map (>= 10 inliers). The first that passes wins."""
        s = self.store
        cands = []
        lc = self.loop_closer
        no_voc = lc is None or lc.voc is None or lc.db is None
        if forced or no_voc:
            lk = self.last_kf_id
            with self.map_lock:
                if lk >= 0 and s.kf_valid[lk]:
                    cands = [int(lk)] + [int(j) for j in s.best_covisible(int(lk), 5)]
        else:
            B = feats.desc.shape[-1]
            bow = bow_vector(lc.voc, transform_words(lc.voc, feats.desc.reshape(-1, B)[feats.valid.reshape(-1)]))
            cands = lc._group_accumulate(lc.db.query(bow, set(), 0.0))[:5]
        if not cands:
            cands = [int(k) for k in s.active_kfs()[-5:]][::-1]
        C, K, B = feats.desc.shape
        cur_desc = feats.desc.reshape(C * K, B)
        cur_rays = feats.rays.reshape(C * K, 3).cpu().numpy()
        cur_valid = feats.valid.reshape(C * K).cpu().numpy()
        Mc = self.rig.Mc.cpu().numpy()
        Rc_all, tc_all = Mc[:, :3, :3], Mc[:, :3, 3]
        ex = self.settings.extractor
        for cand in cands:
            with self.map_lock:
                fk = np.nonzero(s.kf_point[cand] >= 0)[0]
                cdesc_np = s.kf_desc[cand][fk]
                cmask_np = s.kf_dmask[cand][fk]
                cand_pts_row = s.kf_point[cand].copy()
            if len(fk) < 15:
                continue
            cdesc = torch.as_tensor(cdesc_np, device=self.device)
            if self.use_masks:
                d = hamming_matrix_masked(cur_desc, feats.dmask.reshape(C * K, B), cdesc,
                                          torch.as_tensor(cmask_np, device=self.device)).cpu().numpy()
            else:
                d = hamming_matrix(cur_desc, cdesc).cpu().numpy()
            d[~cur_valid] = 1e9
            best = d.argmin(1)
            ok = d.min(1) <= self.th_low
            if ok.sum() < 15:
                continue
            sel = np.nonzero(ok)[0]
            pts = cand_pts_row[fk[best[sel]]]
            cam_idx = sel // K

            def put(a):
                return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=self.device)
            with self.map_lock:
                Xw_np = s.pt_X[pts]
            Xw, rays, Rc, tc = put(Xw_np), put(cur_rays[sel]), put(Rc_all[cam_idx]), put(tc_all[cam_idx])
            valid = torch.ones(len(sel), dtype=torch.bool, device=self.device)
            idx = (self.reloc_sampler(self.frame_id, len(sel)) if self.reloc_sampler is not None
                   else sample_weighted(160, 6, valid, self.generator))
            res = ransac_noncentral_pose(Xw, rays, Rc, tc, valid, idx=idx)
            if int(res.n_inliers) < 10:
                continue
            # gpnp-style refit on the RANSAC inliers (cTracking.cpp:1292)
            Mt_ref = refine_noncentral_pose(Xw, rays, Rc, tc, res.inliers.to(torch.float32))
            pose = hom_to_cayley(Mt_ref.to(torch.float32))
            # confirm by tracking the local map from the recovered pose
            local_pts = self._local_map_points(np.unique(pts))
            if len(local_pts) < 10:
                continue
            lp2, pt_ids2 = self._gather_points(local_pts, STAGE2_CAP)
            out = track_stage(self.mc6, self.intr, self.rig.cams, feats, pose, lp2,
                              scale_factor=ex.scale_factor, n_levels=ex.n_levels, radius=8.0,
                              th_desc=self.th_track, use_masks=self.use_masks, match_fn=self.match_fn)
            pose_f, _, n_ok, assign, inl = out.fetch()
            if n_ok >= 10:
                self._last_reloc_frame = self.frame_id
                self.last_pose = pose_f.copy()
                self.velocity = np.eye(4, dtype=np.float32)
                self._finished.clear()
                ag = np.full(s.cfg.feats_per_kf, BAD_ID, np.int32)
                matched = (assign >= 0) & inl
                ag[matched] = pt_ids2[assign[matched]]
                self.last_assign_global = ag
                m.n_inliers = n_ok
                return True
        return False

    # ------------------------------------------------------------------
    def _global_ba(self):
        """Global BA over every keyframe, the first fixed, at most 10 LM
        iterations (the bootstrap's; loop closing runs none, as the
        reference)."""
        s = self.store
        kfs = s.active_kfs()
        if len(kfs) < 2:
            return
        prob = s.ba_problem(kfs[1:], kfs[:1])
        if prob is None:
            return
        params, obs, free = self.mapper.problem_tensors(prob)
        out, _ = bundle_adjust(params, obs, free, max_iters=10, cg_iters=20)
        s.write_back(prob, poses=out.poses.cpu().numpy(), points=out.points.cpu().numpy())

    # ------------------------------------------------------------------
    def wait_mapping_idle(self):
        """Block until the async worker has drained its queue."""
        if self._kf_queue is not None:
            self._kf_queue.join()

    def reset(self):
        """cTracking::Reset (cTracking.cpp:1353-1401). The async worker's
        queue drains first; frames in flight across the reset are dropped."""
        self.wait_mapping_idle()
        # the vocabulary stays (the reference reloads the same file); the
        # inverted file starts again on the empty map
        self._attach_store(MapStore(self.map_cfg), self.loop_closer.voc if self.loop_closer is not None else None)
        self.state = NOT_INITIALIZED
        self.ref_feats = None
        self.last_assign_global = None
        self.velocity = np.eye(4, dtype=np.float32)
        self._finished.clear()
        self._kf_cut = 0
        self._epoch += 1
        self.ref_kf_id = -1
        self._last_reloc_frame = -(10 ** 9)
        self.frames_since_kf = 0

    def resume(self, store: MapStore):
        """Continue on a map loaded from a checkpoint (io/checkpoint.load_map):
        it replaces the store, with a new mapper and loop closer on it (no
        vocabulary, as the reference's resume builds them), and the system
        is LOST: the next frame tracks from the last pose against the last
        five keyframes' points, then relocalizes. A resumed map is never
        auto-reset. Its keyframes are not in the loop closer's database, so
        relocalization takes the last five keyframes as candidates."""
        self.wait_mapping_idle()
        self._attach_store(store)
        self.state = LOST
        self.map_resumed = True

    def shutdown(self):
        """Join the async worker (cSystem::Shutdown); a no-op in sync mode."""
        if self._worker is not None:
            self._kf_queue.put(None)
            self._worker.join(timeout=300)
            self._worker = None

    def activate_localization_mode(self):
        """cSystem::ActivateLocalizationMode (declared, commented out in the
        reference, cSystem.cpp:187-209): track against the map as it is, with
        no new keyframes, mapping or loop closing."""
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False

    def force_relocalisation(self):
        """cTracking::ForceRelocalisation (cTracking.cpp:1340-1351): the next
        frame takes its pose from relocalization before it tracks."""
        self._force_reloc = True

    # ------------------------------------------------------------------
    def save_trajectory(self, path: str):
        with self.map_lock:
            save_lafida_trajectory(path, self.trajectory, store=self.store)

    def save_checkpoint(self, path: str):
        """The map as a checkpoint (io/checkpoint.save_map)."""
        with self.map_lock:
            save_map(path, self.store)

    def save_metrics(self, path: str):
        """Per-frame metrics as JSON lines, then one summary line."""
        with open(path, "w") as f:
            for m in self.trajectory:
                f.write(json.dumps(dict(frame=m.frame_id, t=m.timestamp, state=m.state,
                                        pose=[float(x) for x in m.pose], n_matches=m.n_matches,
                                        n_inliers=m.n_inliers, track_ms=round(m.track_ms, 3),
                                        keyframe=m.is_keyframe)) + "\n")
            lc = self.loop_closer
            f.write(json.dumps(dict(summary=True, truncated_local_points=int(self._truncated_local_pts),
                                    kf_deferred_mapper_busy=int(self._kf_deferred_busy),
                                    n_keyframes=int(self.store.kf_valid.sum()),
                                    n_points=int(self.store.pt_valid.sum()),
                                    n_loops_closed=lc.n_loops_closed if lc else 0,
                                    # the longest commit phase of a CorrectLoop
                                    loop_locked_max_ms=round(max(lc.locked_phase_ms, default=0.0), 3)
                                    if lc else 0.0)) + "\n")
