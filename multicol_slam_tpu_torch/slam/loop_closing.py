"""Loop closing: detection, Sim3 estimation, correction and the essential
graph (port of `multicol_slam_tpu/slam/loop_closing.py`). It runs after
local mapping of each keyframe: inline in sync mode, on the async mapping
worker otherwise (slam/system.py).

The cLoopClosing thread (cLoopClosing.cpp:63-668):

  DetectLoop   : BoW query (models/vocab.py) without the covisible keyframes,
                 no loop within 10 processed keyframes of the last one, the
                 minimum score from the covisible keyframes, consistency
                 groups chained to 3 (:115-259)
  ComputeSim3  : mutual descriptor matches between map-pointed features
                 (>= 15; the mdBRIEF masked distance at a x0.5 threshold
                 with `use_masks`) -> Horn Sim3 RANSAC in the body frames,
                 scored by reprojection through each observation's camera
                 (ops/ransac.py) -> optimize_sim3 (>= 20 inliers) -> the loop
                 neighbourhood's points projected into the current keyframe
                 from the corrected pose by the best-match kernel K1
                 (SearchByProjection(Scw), cORBmatcher.cpp:2270-2440), >= 20
                 matches in all (:444). As in the reference, this search
                 and SearchAndFuse match without the masks, at the unmasked
                 TH_LOW, even with `use_masks`
  CorrectLoop  : snapshot every pose; propagate the corrected Sim3 through
                 the current keyframe's covisible group and re-map their
                 points (once each); the loop points replace the current
                 keyframe's duplicates; SearchAndFuse over the corrected
                 group (K1 again, :670-745); the essential graph with chain
                 and covisibility edges measured on the snapshot and loop
                 edges on the corrected poses; record the loop edge. No
                 global BA afterwards (the reference removed ORB-SLAM2's).

Detection and the Sim3 check read the store without the map lock (stale
reads are benign: only the worker creates and erases points and
keyframes). CorrectLoop alternates host-numpy commits, each under `lock`,
with device phases between them (the fusion projections, the graph solve
and the point remap) that run with the lock released; the time each
commit holds the lock is kept in `locked_phase_ms`, and the tracker
inserts no keyframe while `loop_correcting` is set.

Conventions: a stored pose M_t maps body -> world; the Sim3 vertices are
S_bw (world -> body), so M_t = inv(SE3(S_bw)) with the translation divided
by the scale (cLoopClosing.cpp:558-567).
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from multicol_slam_tpu_torch.models.rig import MultiCamRig
from multicol_slam_tpu_torch.models.vocab import (
    KeyFrameDatabase, Vocabulary, bow_score, bow_vector, build_vocabulary, transform_words,
)
from multicol_slam_tpu_torch.ops.best_match import masked_best_match_cams
from multicol_slam_tpu_torch.ops.matching import hamming_matrix, hamming_matrix_masked
from multicol_slam_tpu_torch.ops.ransac import ransac_sim3
from multicol_slam_tpu_torch.optim.ba import (
    Sim3Edges, Sim3Obs, _project_body, optimize_essential_graph, optimize_sim3,
)
from multicol_slam_tpu_torch.slam.features import FrameFeatures
from multicol_slam_tpu_torch.slam.local_mapping import _NullLock, fuse_match
from multicol_slam_tpu_torch.slam.map_store import (
    MapStore, cayley_to_hom_np, hom_inverse_np, hom_to_cayley_np,
)
from multicol_slam_tpu_torch.slam.tracking_kernels import LocalPoints
from multicol_slam_tpu_torch.utils.geometry import sim3_exp, sim3_inverse, sim3_log

MIN_KFS_BETWEEN_LOOPS = 10     # cLoopClosing.cpp:129
CONSISTENCY_TH = 3             # :48
MIN_BOW_MATCHES = 15           # :299
MIN_SIM3_INLIERS = 20          # :378
MIN_TOTAL_MATCHES = 20         # :444
COVIS_EDGE_MIN = 100           # essential-graph covisibility weight (:309)
SIM3_REPROJ_CHI2 = 9.210       # cSim3Solver's per-observation gate (:374-416)
VOCAB_TRAIN_DESCS = 3000       # descriptors gathered before the vocabulary trains
EG_DENSE_LIMIT = 300           # optimize_essential_graph's dense_limit


def _np_sim3_apply(R: np.ndarray, t: np.ndarray, s: float, X: np.ndarray) -> np.ndarray:
    return (s * (X @ R.T) + t).astype(np.float32)


def _np_sim3_inverse(R: np.ndarray, t: np.ndarray, s: float):
    Ri = R.T
    si = 1.0 / s
    return Ri, -si * (Ri @ t), si


def _np_sim3_compose(Ra, ta, sa, Rb, tb, sb):
    """(Ra, ta, sa) o (Rb, tb, sb): b first, then a."""
    return Ra @ Rb, sa * (Ra @ tb) + ta, sa * sb


class LoopCloser:
    """`match_fn` is the best-match kernel's wrapper (or its plain version)
    that the Sim3 check and SearchAndFuse project with. `sim3_sampler(
    kf_frame_id, n) -> [300, 3]` gives the Sim3 RANSAC's hypotheses (default:
    drawn from `generator`). `lock`: the system's map lock in async mode;
    `yield_gate`, when set, is called before each device phase.
    `use_masks`: the Sim3 candidate matches take the mdBRIEF masked
    distance."""

    def __init__(self, store: MapStore, rig: MultiCamRig, voc: Optional[Vocabulary] = None,
                 match_fn: Callable = masked_best_match_cams, sim3_sampler: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None, lock=None, use_masks: bool = False):
        self.store = store
        self.use_masks = use_masks
        self.lock = lock if lock is not None else _NullLock()
        self.yield_gate: Optional[Callable[[], None]] = None
        # True while CorrectLoop runs: the tracker inserts no keyframe
        # meanwhile (cTracking.cpp:899-901)
        self.loop_correcting = False
        self.rig = rig
        self.device = rig.Mc.device
        self.voc = voc
        self.match_fn = match_fn
        self.sim3_sampler = sim3_sampler
        self.generator = generator
        self.db: Optional[KeyFrameDatabase] = KeyFrameDatabase(voc) if voc else None
        self.consistency_groups: List[Tuple[Set[int], int]] = []
        self.mc6 = rig.Mc_cayley.to(torch.float32)
        self.intr = rig.cams.to_vector()
        self.n_loops_closed = 0
        # ms each commit phase of CorrectLoop held the lock, and the [start,
        # end] (perf_counter) of each CorrectLoop
        self.locked_phase_ms: List[float] = []
        self.correct_spans: List[Tuple[float, float]] = []
        self._bootstrap_descs: List[np.ndarray] = []
        # processed-keyframe counter for the 10-keyframe gate (slot ids are
        # recycled, so they are not monotonic)
        self._n_processed = 0
        self._last_loop_at = -MIN_KFS_BETWEEN_LOOPS
        store.on_kf_erased.append(self.on_keyframe_erased)

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def _ensure_vocab(self, k: int) -> bool:
        """Without a vocabulary, train one from the first keyframes'
        descriptors once there are VOCAB_TRAIN_DESCS of them (the reference
        requires a trained file; training its own keeps the system
        standalone) and add every earlier keyframe to the database."""
        if self.voc is not None:
            return True
        s = self.store
        descs = s.kf_desc[k][s.kf_feat_valid[k]]
        if len(descs):
            self._bootstrap_descs.append(descs)
        if sum(len(d) for d in self._bootstrap_descs) < VOCAB_TRAIN_DESCS:
            return False
        self.voc = build_vocabulary(np.concatenate(self._bootstrap_descs), k=9, depth=3, device=self.device)
        self.db = KeyFrameDatabase(self.voc)
        self._bootstrap_descs = []
        for j in np.nonzero(s.kf_valid)[0]:
            if int(j) != k:
                self.db.add(int(j), self._kf_bow(int(j)))
        return True

    def _kf_bow(self, k: int) -> Dict[int, float]:
        s = self.store
        return bow_vector(self.voc, transform_words(self.voc, s.kf_desc[k][s.kf_feat_valid[k]], device=self.device))

    def on_keyframe_erased(self, k: int):
        """Keep the inverted file in step with keyframe culling (the
        reference's mpKeyFrameDB->erase in SetBadFlag)."""
        if self.db is not None:
            self.db.erase(int(k))

    # ------------------------------------------------------------------
    def process(self, k: int) -> bool:
        """The loop pipeline for new keyframe k. True when a loop closed (the
        store's poses and points corrected)."""
        self._n_processed += 1
        if not self._ensure_vocab(k):
            return False
        bow_k = self._kf_bow(k)
        candidates = self._detect(k, bow_k)
        self.db.add(k, bow_k)
        for cand in candidates:
            if self._try_close(k, cand):
                self.n_loops_closed += 1
                self._last_loop_at = self._n_processed
                self.consistency_groups = []
                return True
        return False

    # ------------------------------------------------------------------
    def _detect(self, k: int, bow_k) -> List[int]:
        """DetectLoop (cLoopClosing.cpp:115-259)."""
        s = self.store
        if self._n_processed - self._last_loop_at < MIN_KFS_BETWEEN_LOOPS or s.kf_valid.sum() < MIN_KFS_BETWEEN_LOOPS:
            return []
        # exclusion and minScore over the CONNECTED keyframes (weight >= 15)
        cov = s.covisibility(k, min_weight=15)
        exclude = set(cov) | {k}
        min_score = 1.0
        for j in cov:
            min_score = min(min_score, bow_score(bow_k, self.db.kf_bow.get(j, {})))
        cands = self.db.query(bow_k, exclude, max(min_score, 0.01))
        if not cands:
            self.consistency_groups = []
            return []
        # candidates vote as covisible groups (cMultiKeyFrameDatabase.cpp:162-211)
        score = dict(cands)
        cands = [(kf, score[kf]) for kf in self._group_accumulate(cands)]
        # consistency-group chaining (:190-250)
        new_groups: List[Tuple[Set[int], int]] = []
        consistent: List[int] = []
        for kf, _ in cands:
            group = set(s.covisibility(kf)) | {kf}
            matched = False
            for prev_group, count in self.consistency_groups:
                if group & prev_group:
                    new_groups.append((group, count + 1))
                    if count + 1 >= CONSISTENCY_TH:
                        consistent.append(kf)
                    matched = True
                    break
            if not matched:
                new_groups.append((group, 1))
        self.consistency_groups = new_groups
        return consistent

    def _group_accumulate(self, cands: List[Tuple[int, float]]) -> List[int]:
        """Covisibility-group score accumulation of loop detection and of
        relocalization retrieval (cMultiKeyFrameDatabase.cpp:162-211,
        :284-330): each candidate's 10 best covisible keyframes pool the
        scores of those that are candidates too; the group's best member
        stands for it; groups under 0.75 x the best pooled score drop out.
        Returns the representatives, best group first."""
        s = self.store
        score = dict(cands)
        out: Dict[int, float] = {}
        best_acc = 0.0
        for kf, sc in cands:
            acc = sc
            best_kf, best_sc = kf, sc
            for j in s.best_covisible(kf, 10):
                sj = score.get(j)
                if sj is not None:
                    acc += sj
                    if sj > best_sc:
                        best_kf, best_sc = j, sj
            out[best_kf] = max(out.get(best_kf, 0.0), acc)
            best_acc = max(best_acc, acc)
        th = 0.75 * best_acc
        keep = sorted(((a, kf) for kf, a in out.items() if a >= th), reverse=True)
        return [kf for _, kf in keep]

    # ------------------------------------------------------------------
    def _loop_neighborhood_points(self, cand: int) -> np.ndarray:
        """The points of the loop keyframe and its covisible group (the
        reference's mvpLoopMapPoints, cLoopClosing.cpp:~430)."""
        s = self.store
        group = list(s.covisibility(cand, min_weight=15)) + [cand]
        pts = s.kf_point[np.asarray(group, np.int64)]
        pts = np.unique(pts[pts >= 0])
        return pts[s.pt_valid[pts]] if len(pts) else pts

    def _candidate_distances(self, k: int, cand: int, fk: np.ndarray, fc: np.ndarray):
        """The Hamming matrix [len(fk), len(fc)] between the two keyframes'
        features fk and fc (host numpy) and its threshold: TH_LOW, or the
        masked distance at TH_LOW x0.5 with `use_masks`."""
        s = self.store
        if self.use_masks:
            d = hamming_matrix_masked(self._t(s.kf_desc[k][fk]), self._t(s.kf_dmask[k][fk]),
                                      self._t(s.kf_desc[cand][fc]), self._t(s.kf_dmask[cand][fc]))
            return d.cpu().numpy(), 1.0 * s.cfg.desc_bytes
        d = hamming_matrix(self._t(s.kf_desc[k][fk]), self._t(s.kf_desc[cand][fc]))
        return d.cpu().numpy(), 2.0 * s.cfg.desc_bytes

    def _project_loop_points(self, k: int, pose6_corr: np.ndarray, pts: np.ndarray,
                             radius: float = 10.0, th_desc: float = 64.0) -> np.ndarray:
        """SearchByProjection(Scw) (cORBmatcher.cpp:2270-2440): the points
        `pts` projected into keyframe k's features from pose `pose6_corr`
        and matched by K1 (fuse_match) without the mdBRIEF masks, whatever
        `use_masks` says (the reference's). Returns assign [F]: index into
        pts, or -1."""
        s = self.store
        C, K = s.cfg.n_cams, s.cfg.feats_per_cam
        lp = LocalPoints(X=self._t(s.pt_X[pts]), desc=self._t(s.pt_desc[pts]), min_dist=self._t(s.pt_min_dist[pts]),
                         max_dist=self._t(s.pt_max_dist[pts]),
                         valid=torch.ones(len(pts), dtype=torch.bool, device=self.device))
        fk = FrameFeatures(
            uv=self._t(s.kf_uv[k].reshape(C, K, 2)),
            response=torch.zeros((C, K), dtype=torch.float32, device=self.device),
            octave=self._t(s.kf_octave[k].reshape(C, K)), angle=self._t(s.kf_angle[k].reshape(C, K)),
            rays=self._t(s.kf_rays[k].reshape(C, K, 3)), desc=self._t(s.kf_desc[k].reshape(C, K, -1)),
            dmask=self._t(s.kf_dmask[k].reshape(C, K, -1)), valid=self._t(s.kf_feat_valid[k].reshape(C, K)),
        )
        _, _, _, packed = fuse_match(self.mc6, self.intr, self.rig.cams, fk,
                                     self._t(np.asarray(pose6_corr, np.float32)), lp, radius, match_fn=self.match_fn)
        packed = packed.cpu().numpy()                               # one readback: [3, C*K]
        keep = (packed[2] > 0.5) & (packed[1] <= th_desc)
        out = np.full(s.cfg.feats_per_kf, -1, np.int64)
        out[keep] = packed[0][keep].astype(np.int64)
        return out

    # ------------------------------------------------------------------
    def _try_close(self, k: int, cand: int) -> bool:
        """ComputeSim3 (cLoopClosing.cpp:261-461), then CorrectLoop, for one
        candidate."""
        s = self.store
        self._yield()
        # mutual descriptor matches between the map-pointed features of the
        # two keyframes (the capability of SearchByBoW, by a dense Hamming
        # matrix)
        fk = np.nonzero(s.kf_point[k] >= 0)[0]
        fc = np.nonzero(s.kf_point[cand] >= 0)[0]
        if len(fk) < MIN_BOW_MATCHES or len(fc) < MIN_BOW_MATCHES:
            return False
        d, th = self._candidate_distances(k, cand, fk, fc)
        best = d.argmin(1)
        mutual = d.argmin(0)[best] == np.arange(len(fk))
        okm = mutual & (d.min(1) <= th)
        if okm.sum() < MIN_BOW_MATCHES:
            return False
        fk_m, fc_m = fk[okm], fc[best[okm]]
        pk, pc = s.kf_point[k][fk_m], s.kf_point[cand][fc_m]
        # the points in each body frame (cSim3Solver works in body frames)
        Tk = cayley_to_hom_np(s.kf_pose[k])      # body -> world
        Tc = cayley_to_hom_np(s.kf_pose[cand])
        Xb_k = ((s.pt_X[pk] - Tk[:3, 3]) @ Tk[:3, :3]).astype(np.float32)
        Xb_c = ((s.pt_X[pc] - Tc[:3, 3]) @ Tc[:3, :3]).astype(np.float32)
        # Horn Sim3 RANSAC, S_kc: cand body -> current body. An inlier
        # reprojects both ways through its observing camera within chi2
        # (cSim3Solver::CheckInliers, cSim3Solver.cpp:374-416)
        P, Q = self._t(Xb_c), self._t(Xb_k)
        cam_k = self._t((fk_m // s.cfg.feats_per_cam).astype(np.int64))
        cam_c = self._t((fc_m // s.cfg.feats_per_cam).astype(np.int64))
        uv_k, uv_c = self._t(s.kf_uv[k][fk_m]), self._t(s.kf_uv[cand][fc_m])

        def err_fn(R, t, sc):
            X2in1 = sc[:, None, None] * torch.einsum("sij,nj->sni", R, P) + t[:, None, :]
            Ri, ti, si = sim3_inverse(R, t, sc)
            X1in2 = si[:, None, None] * torch.einsum("sij,nj->sni", Ri, Q) + ti[:, None, :]
            uv1p, z1 = _project_body(self.mc6, self.intr, cam_k, X2in1)
            uv2p, z2 = _project_body(self.mc6, self.intr, cam_c, X1in2)
            e1 = torch.sum((uv1p - uv_k) ** 2, -1)
            e2 = torch.sum((uv2p - uv_c) ** 2, -1)
            return (z1 > 0) & (z2 > 0) & (e1 < SIM3_REPROJ_CHI2) & (e2 < SIM3_REPROJ_CHI2)

        # with_scale=False and fix_scale=True: the rig is metric (a known
        # extrinsic baseline pins the map's scale), so the loop transform is
        # rigid; the reference keeps the mono-inherited 7-dof solver
        idx = None
        if self.sim3_sampler is not None:
            idx = self.sim3_sampler(int(s.kf_frame_id[k]), len(fk_m))
        ones = torch.ones(len(fk_m), dtype=torch.float32, device=self.device)
        res = ransac_sim3(P, Q, ones > 0, err_fn, n_hyp=300, with_scale=False, generator=self.generator, idx=idx)
        if int(res.n_inliers) < MIN_SIM3_INLIERS // 2:
            return False
        # reprojection Gauss-Newton on the RANSAC inliers (optimize_sim3)
        sobs = Sim3Obs(X1=Q, X2=P, uv1=uv_k, uv2=uv_c, cam1=cam_k, cam2=cam_c, inv_sigma2_1=ones,
                       inv_sigma2_2=ones, valid=res.inliers)
        v7, inl, n_inl = optimize_sim3(sim3_log(res.R, res.t, res.s), sobs, self.mc6, self.intr, n_iters=12,
                                       fix_scale=True)
        if int(n_inl) < MIN_SIM3_INLIERS:
            return False
        R, t, sc = (a.cpu().numpy() for a in sim3_exp(v7))
        v7 = v7.cpu().numpy()
        # Sim3-guided expansion (SearchBySim3 + SearchByProjection(Scw)):
        # the loop neighbourhood's points projected into k from the
        # corrected pose; >= 20 matches in all
        Tc_bw = hom_inverse_np(cayley_to_hom_np(s.kf_pose[cand]))
        Rkw, tkw, skw = _np_sim3_compose(R, t, float(sc), Tc_bw[:3, :3], Tc_bw[:3, 3], 1.0)
        Tbw_corr = np.eye(4)
        Tbw_corr[:3, :3] = Rkw
        Tbw_corr[:3, 3] = tkw / skw
        pose_corr = hom_to_cayley_np(hom_inverse_np(Tbw_corr))
        loop_pts = self._loop_neighborhood_points(cand)
        if len(loop_pts) == 0:
            return False
        assign = self._project_loop_points(k, pose_corr, loop_pts)
        # matches in all: features of k matched to a loop point by the Sim3
        # inliers or the projection (mvpCurrentMatchedPoints, :431-448)
        inl_np = inl.cpu().numpy()
        matched_feats = set(np.nonzero(assign >= 0)[0].tolist())
        matched_feats.update(int(f) for f in fk_m[inl_np])
        if len(matched_feats) < MIN_TOTAL_MATCHES:
            return False
        # feature -> loop point, for the duplicate replacement in _correct;
        # the Sim3 inliers map k's feature to cand's point directly
        loop_match: Dict[int, int] = {int(f): int(loop_pts[assign[f]]) for f in np.nonzero(assign >= 0)[0]}
        for f, p2, good in zip(fk_m, pc, inl_np):
            if good:
                loop_match[int(f)] = int(p2)
        self._correct(k, cand, v7, loop_match, loop_pts)
        return True

    # ------------------------------------------------------------------
    def _yield(self):
        if self.yield_gate is not None:
            self.yield_gate()

    @contextlib.contextmanager
    def _commit(self):
        """A commit phase of CorrectLoop: under the lock, the ms it held the
        lock recorded."""
        with self.lock:
            t0 = time.perf_counter()
            yield
            self.locked_phase_ms.append((time.perf_counter() - t0) * 1e3)

    def _correct(self, k: int, cand: int, v7_kc: np.ndarray, loop_match: Dict[int, int], loop_pts: np.ndarray):
        """CorrectLoop (cLoopClosing.cpp:464-668). S_kc maps cand-body points
        into k's body, so k's corrected world -> body is S_kc o T_bw(cand).
        The commits are host numpy under the lock; the SearchAndFuse
        projections, the graph solve and the point remap run between them
        with the lock released."""
        s = self.store
        self.loop_correcting = True
        t_start = time.perf_counter()
        try:
            with self._commit():
                corrected, snapshot, remapped, remap_ref = self._propagate_correction(k, cand, v7_kc, loop_match)
            # SearchAndFuse (:670-745): the loop points into every keyframe of
            # the corrected group, from its corrected pose
            loop_pts_v = loop_pts[s.pt_valid[loop_pts]]
            fuse_assign: Dict[int, np.ndarray] = {}
            for j in corrected:
                if s.kf_valid[j] and len(loop_pts_v):
                    self._yield()
                    fuse_assign[j] = self._project_loop_points(j, s.kf_pose[j], loop_pts_v, radius=6.0)
            with self._commit():
                self._commit_fuse(fuse_assign, loop_pts_v)
                s.update_point_stats_many(np.asarray(sorted(remapped), np.int64))
                prob = self._eg_build(k, cand, corrected, snapshot, remap_ref)
            if prob is not None:
                self._yield()
                sol = self._eg_solve(prob)
                with self._commit():
                    self._eg_commit(prob, sol)
            with self._commit():
                s.loop_edges.append((k, cand))
        finally:
            self.loop_correcting = False
            self.correct_spans.append((t_start, time.perf_counter()))

    def _propagate_correction(self, k: int, cand: int, v7_kc: np.ndarray, loop_match: Dict[int, int]):
        """Snapshot every pose, propagate the corrected Sim3 through k's
        covisible group, re-map their points, and let the loop points
        replace k's duplicates (host numpy)."""
        s = self.store
        # the snapshot comes first: the graph's chain and covisibility edges
        # are measured on the uncorrected poses (NonCorrectedSim3, :497-520)
        snapshot: Dict[int, np.ndarray] = {int(j): hom_inverse_np(cayley_to_hom_np(s.kf_pose[j]))
                                           for j in s.active_kfs()}
        R, t, sc = (a.cpu().numpy().astype(np.float64) for a in sim3_exp(self._t(np.asarray(v7_kc, np.float32))))
        sc = float(sc)
        Tc_bw = snapshot[cand]
        # S_kw_corr = S_kc o T_cand_bw (world -> current body, with scale)
        Rkw, tkw, skw = _np_sim3_compose(R, t, sc, Tc_bw[:3, :3], Tc_bw[:3, 3], 1.0)
        Tk_bw_old = snapshot[k]
        group = [j for j in list(s.covisibility(k, min_weight=15)) + [k] if j != cand]
        corrected: Dict[int, Tuple[np.ndarray, np.ndarray, float]] = {}
        remapped: Set[int] = set()
        # the group keyframe that re-mapped each point (mnCorrectedByKF,
        # :520-545): the graph's point remap anchors the point there
        remap_ref: Dict[int, int] = {}
        for j in group:
            Tj_bw_old = snapshot[int(j)]
            # T_jk = T_j_bw_old inv(T_k_bw_old): current body -> j's body
            Tjk = Tj_bw_old @ np.linalg.inv(Tk_bw_old)
            Rj, tj, sj = _np_sim3_compose(Tjk[:3, :3], Tjk[:3, 3], 1.0, Rkw, tkw, skw)
            corrected[int(j)] = (Rj, tj, sj)
            # the SE3 pose back: M_t = inv([R, t / s])
            Tbw = np.eye(4)
            Tbw[:3, :3] = Rj
            Tbw[:3, 3] = tj / sj
            s.kf_pose[j] = hom_to_cayley_np(np.linalg.inv(Tbw))
            # re-map j's points once: X_new = S_jw_corr^-1 (T_jw_old X)
            pts = s.kf_point[j]
            pts = np.unique(pts[pts >= 0])
            pts = np.asarray([p for p in pts if p not in remapped], np.int64)
            if len(pts) == 0:
                continue
            remapped.update(int(p) for p in pts)
            for p in pts:
                remap_ref[int(p)] = int(j)
            Xb_old = s.pt_X[pts] @ Tj_bw_old[:3, :3].T + Tj_bw_old[:3, 3]
            s.pt_X[pts] = _np_sim3_apply(*_np_sim3_inverse(Rj, tj, sj), Xb_old)
        # where a loop point matched a feature of k that has a (drift-built)
        # point already, the loop point wins (:636-660)
        for f, p_loop in loop_match.items():
            if not s.pt_valid[p_loop]:
                continue
            existing = int(s.kf_point[k, f])
            if existing == p_loop:
                continue
            if existing >= 0 and s.pt_valid[existing]:
                s.replace_point(existing, p_loop)
            else:
                s.add_observation(k, int(f), p_loop)
        return corrected, snapshot, remapped, remap_ref

    def _commit_fuse(self, fuse_assign: Dict[int, np.ndarray], loop_pts: np.ndarray):
        """The SearchAndFuse matches: a conflicting point is REPLACED by the
        loop point (cLoopClosing.cpp:670-745)."""
        s = self.store
        touched: List[int] = []
        for j, assign in fuse_assign.items():
            if not s.kf_valid[j]:
                continue
            for f in np.nonzero(assign >= 0)[0]:
                p_loop = int(loop_pts[assign[f]])
                if not s.pt_valid[p_loop]:
                    continue
                existing = int(s.kf_point[j, f])
                if existing == p_loop:
                    continue
                if existing >= 0 and s.pt_valid[existing]:
                    s.replace_point(existing, p_loop)
                else:
                    s.add_observation(j, int(f), p_loop)
                touched.append(p_loop)
        if touched:
            s.update_point_stats_many(np.asarray(touched))

    # ------------------------------------------------------------------
    def _essential_graph(self, k: int, cand: int, corrected: Dict[int, Tuple], snapshot: Dict[int, np.ndarray],
                         remap_ref: Optional[Dict[int, int]] = None):
        """Build, solve and commit in one call (what _correct does in three
        phases)."""
        prob = self._eg_build(k, cand, corrected, snapshot, remap_ref)
        if prob is not None:
            self._eg_commit(prob, self._eg_solve(prob))

    def _eg_build(self, k: int, cand: int, corrected: Dict[int, Tuple], snapshot: Dict[int, np.ndarray],
                  remap_ref: Optional[Dict[int, int]] = None):
        """The problem of OptimizeEssentialGraph (cOptimizerLoopStuff.cpp:
        273-520), host numpy: vertices from the corrected Sim3s (the group)
        or the snapshot (the others); chain and covisibility edges measured
        on the snapshot, loop edges on the corrected estimates, so that the
        residual at the group's border is the loop correction and the solve
        spreads it over the graph. Holds the points' snapshot for the
        remap."""
        s = self.store
        kfs = [int(j) for j in s.active_kfs()]
        idx = {j: i for i, j in enumerate(kfs)}
        K = len(kfs)
        if K < 3:
            return None

        def _fallback_bw(j):
            # a keyframe newer than the snapshot: its current pose
            return hom_inverse_np(cayley_to_hom_np(s.kf_pose[j]))

        vR = np.zeros((K, 3, 3), np.float32)
        vt = np.zeros((K, 3), np.float32)
        vs = np.ones(K, np.float32)
        for j in kfs:
            i = idx[j]
            if j in corrected:
                vR[i], vt[i], vs[i] = corrected[j]
            else:
                Tbw = snapshot.get(j)
                if Tbw is None:
                    Tbw = _fallback_bw(j)
                vR[i], vt[i], vs[i] = Tbw[:3, :3], Tbw[:3, 3], 1.0
        ei, ej, wts = [], [], []
        mR, mt, ms = [], [], []

        def _snap_sim3(j):
            Tbw = snapshot.get(j)
            if Tbw is None:
                Tbw = _fallback_bw(j)
            return Tbw[:3, :3], Tbw[:3, 3], 1.0

        def _curr_sim3(j):
            return corrected[j] if j in corrected else _snap_sim3(j)

        def add_edge(a: int, b: int, from_snapshot: bool, weight: float = 1.0):
            get = _snap_sim3 if from_snapshot else _curr_sim3
            Ra, ta, sa = get(a)
            Rb, tb, sb = get(b)
            # the measurement S_ba = S_b o S_a^-1
            Rm, tm, sm = _np_sim3_compose(Rb, tb, sb, *_np_sim3_inverse(Ra, ta, sa))
            ei.append(idx[a])
            ej.append(idx[b])
            mR.append(Rm)
            mt.append(tm)
            ms.append(sm)
            wts.append(weight)

        # spanning-tree chain (cOptimizerLoopStuff.cpp:380-420): each keyframe
        # to its max-covisibility parent; one without a live parent (the
        # root, rare orphans) to its time predecessor. Uniform weights.
        ordered = sorted(kfs, key=lambda j: int(s.kf_frame_id[j]))
        pos = {j: i for i, j in enumerate(ordered)}
        for b in ordered[1:]:
            a = int(s.kf_parent[b])
            if a not in idx or a == b:
                a = ordered[pos[b] - 1]
            add_edge(a, b, from_snapshot=True)
        cov_done = set()
        for a in ordered:
            for b, w in s.covisibility(a).items():
                if w >= COVIS_EDGE_MIN and (b, a) not in cov_done and b in idx:
                    add_edge(a, b, from_snapshot=True)
                    cov_done.add((a, b))
        for (a, b) in s.loop_edges + [(k, cand)]:
            if a in idx and b in idx:
                add_edge(a, b, from_snapshot=False, weight=5.0)
        fixed = np.zeros(K, bool)
        fixed[idx[cand]] = True
        # the points' snapshot: each remaps by its first (or corrector)
        # keyframe's old -> new transform (:480-520)
        pts = s.active_points()
        refs = s.pt_first_kf[pts].copy()
        if remap_ref and len(pts):
            rr = np.asarray(list(remap_ref.items()), np.int64)   # [M, 2]
            ppos = np.clip(np.searchsorted(pts, rr[:, 0]), 0, len(pts) - 1)
            ok = pts[ppos] == rr[:, 0]
            refs[ppos[ok]] = rr[ok, 1]
        return dict(kfs=kfs, idx=idx, vR=vR, vt=vt, vs=vs,
                    ei=np.asarray(ei, np.int32), ej=np.asarray(ej, np.int32), wts=np.asarray(wts, np.float32),
                    mR=np.stack(mR).astype(np.float32), mt=np.stack(mt).astype(np.float32),
                    ms=np.asarray(ms, np.float32), fixed=fixed, pts=pts, refs=refs, ptX=s.pt_X[pts].copy())

    def _eg_solve(self, prob):
        """The device solve (the log maps, 15 Gauss-Newton steps over every
        keyframe, the exp maps) and the host float64 pose recovery and point
        remap on the problem's snapshot. No store access."""
        kfs = prob["kfs"]
        K = len(kfs)
        v = sim3_log(self._t(prob["vR"]), self._t(prob["vt"]), self._t(prob["vs"]))
        meas = sim3_log(self._t(prob["mR"]), self._t(prob["mt"]), self._t(prob["ms"]))
        E = len(prob["ei"])
        edges = Sim3Edges(self._t(prob["ei"], torch.int64), self._t(prob["ej"], torch.int64), meas,
                          self._t(prob["wts"]), torch.ones(E, dtype=torch.bool, device=self.device))
        # the reference chooses the dense solve or PCG on K padded to a power
        # of two (at least 16)
        padded = max(16, 1 << (K - 1).bit_length())
        v_out = optimize_essential_graph(v, edges, self._t(prob["fixed"]), n_iters=15,
                                         dense_limit=EG_DENSE_LIMIT if padded <= EG_DENSE_LIMIT else 0)
        Ro_all, to_all, so_all = (a.cpu().numpy().astype(np.float64) for a in sim3_exp(v))
        Rn_all, tn_all, sn_all = (a.cpu().numpy().astype(np.float64) for a in sim3_exp(v_out))
        new_pose6 = np.zeros((K, 6), np.float32)
        old_bw: Dict[int, np.ndarray] = {}
        new_sim3: Dict[int, Tuple[np.ndarray, np.ndarray, float]] = {}
        for i, j in enumerate(kfs):
            Told = np.eye(4)
            Told[:3, :3] = Ro_all[i]
            Told[:3, 3] = to_all[i] / so_all[i]
            old_bw[j] = Told
            new_sim3[j] = (Rn_all[i], tn_all[i], float(sn_all[i]))
            Tbw = np.eye(4)
            Tbw[:3, :3] = Rn_all[i]
            Tbw[:3, 3] = tn_all[i] / sn_all[i]
            new_pose6[i] = hom_to_cayley_np(np.linalg.inv(Tbw))
        # the point remap on the SNAPSHOT positions, one pass a keyframe
        refs, ptX = prob["refs"], prob["ptX"].copy()
        for j in np.unique(refs):
            j = int(j)
            if j not in new_sim3:
                continue
            sel = refs == j
            Told = old_bw[j]
            Xb = ptX[sel] @ Told[:3, :3].T + Told[:3, 3]
            ptX[sel] = _np_sim3_apply(*_np_sim3_inverse(*new_sim3[j]), Xb)
        return dict(new_pose6=new_pose6, newX=ptX)

    def _eg_commit(self, prob, sol):
        """Write the optimized poses of the keyframes and the remapped
        positions of the points that are still valid."""
        s = self.store
        for i, j in enumerate(prob["kfs"]):
            if s.kf_valid[j]:
                s.kf_pose[j] = sol["new_pose6"][i]
        pts = prob["pts"]
        if len(pts):
            alive = s.pt_valid[pts]
            s.pt_X[pts[alive]] = sol["newX"][alive]
