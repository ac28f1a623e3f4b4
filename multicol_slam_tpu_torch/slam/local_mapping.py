"""Local mapping: new-point triangulation, culling, fusion, local BA (port of
`multicol_slam_tpu/slam/local_mapping.py`).

The cLocalMapping loop (cLocalMapping.cpp:69-597) runs on the host after
each keyframe insertion, inline in sync mode or on the async mapping worker
(slam/system.py), each device stage one batched program with one packed
readback:

  ProcessNewMultiKeyFrame -> MapStore bookkeeping (map_store.py)
  MapPointCulling         -> cull_map_points (host)
  CreateNewMapPoints      -> triangulate_pairs over the neighbour pairs
  SearchInNeighbors/Fuse  -> fuse_neighbors: fuse_match (the best-match
                             kernel K1 over the targets' cameras) + host merge
  LocalBundleAdjustment   -> optim/ba.bundle_adjust_interruptible
  KeyFrameCulling         -> cull_keyframes (host)

Each stage snapshots the store under `lock`, runs its device work without
it, and commits under it with validity re-checks, so that an async tracker
never waits for a device solve. With a `yield_gate` (the worker's
tracker-priority gate) the launches are bounded: triangulation pairs in
chunks of 2, fusion targets in groups of 6, BA one LM iteration a chunk
with 16 PCG steps; without one, each stage is one launch.

The reference pads each device problem to a shape bucket so that XLA
compiles a handful of programs; PyTorch compiles nothing, so the port runs
every problem at its own size (the padding rows change no result).
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from multicol_slam_tpu_torch import native
from multicol_slam_tpu_torch.models.rig import MultiCamRig
from multicol_slam_tpu_torch.ops.best_match import masked_best_match_cams
from multicol_slam_tpu_torch.ops.matching import hamming_matrix, hamming_matrix_masked, rotation_consistency
from multicol_slam_tpu_torch.optim.ba import bundle_adjust_interruptible, prune_observations
from multicol_slam_tpu_torch.optim.problem import BAParams, FreeMask, Observations, intr_project
from multicol_slam_tpu_torch.slam.features import FrameFeatures
from multicol_slam_tpu_torch.slam.map_store import BAD_ID, MapStore, cayley_to_hom_np, hom_to_cayley_np
from multicol_slam_tpu_torch.slam.tracking_kernels import LocalPoints, project_and_match
from multicol_slam_tpu_torch.utils.geometry import (
    cayley_to_hom, essential_from_relative, hom_inverse, ray_epipolar_distance, transform_points,
    triangulate_midpoint,
)

# Gates (cLocalMapping.cpp:39-43, 255, 305, 332, 363)
MIN_BASELINE_DEPTH_RATIO = 0.01
MAX_PARALLAX_COS = 0.9998        # a bit over 1 degree of parallax
REPROJ_TH = 4.0
MAX_DIST = 25.0
FOUND_RATIO_MIN = 0.25
KF_REDUNDANT_FRAC = 0.9
KF_REDUNDANT_OBS = 5
BIGD = 1e9


class TriangulationOut(NamedTuple):
    X: torch.Tensor        # [..., C*K, 3] new world points
    feat1: torch.Tensor    # [C*K] flat feature index in keyframe 1 (== arange(C*K))
    feat2: torch.Tensor    # [..., C*K] flat feature index in keyframe 2
    ok: torch.Tensor       # [..., C*K] bool
    packed: torch.Tensor   # [..., C*K, 5] f32: X, feat2, ok (one readback)


def triangulate_pairs(
    mc6: torch.Tensor,
    pose1: torch.Tensor,
    poses2: torch.Tensor,
    uv1, rays1, desc1, free1,      # keyframe 1's features [C, K, ...]; free = no map point yet
    uv2s, rays2s, desc2s, free2s,  # the neighbours' [J, C, K, ...]
    intr: torch.Tensor,
    epi_th: float = 1e-2,
    th_desc: float = 64.0,
    ratio: float = 0.8,
    ang1=None, ang2s=None,         # keypoint angles (the rotation histogram)
    dmask1=None, dmask2s=None,     # mdBRIEF stability masks [C, K, B], [J, C, K, B]
    check_rotation: bool = False,
    use_masks: bool = False,
) -> TriangulationOut:
    """Match unassigned same-camera features between keyframe 1 and each of
    J neighbours under the epipolar constraint and triangulate
    (SearchForTriangulationRaw, cORBmatcher.cpp:988-1090, and the
    CreateNewMapPoints gates, cLocalMapping.cpp:224-387), all pairs and
    cameras at once. check_rotation applies the rotHist filter (:1070-1090)
    per pair. The Hamming matrix is the dense +-1 product (`hamming_matrix`),
    or with use_masks the mdBRIEF masked distance (pass a x0.5 th_desc)."""
    J = poses2.shape[0]
    C, K, _ = desc1.shape
    Mc = cayley_to_hom(mc6)                                           # [C, 4, 4]
    MtMc1 = torch.matmul(cayley_to_hom(pose1), Mc)                    # [C, 4, 4]
    MtMc2 = torch.matmul(cayley_to_hom(poses2)[:, None], Mc)          # [J, C, 4, 4]
    # per camera: cam1 <- cam2, and E of its inverse
    rel = torch.matmul(hom_inverse(MtMc1), MtMc2)
    E = essential_from_relative(hom_inverse(rel))                     # [J, C, 3, 3]
    if use_masks and dmask1 is not None:
        ham = hamming_matrix_masked(desc1, dmask1, desc2s, dmask2s)   # [J, C, K1, K2]
    else:
        ham = hamming_matrix(desc1, desc2s)
    epi = ray_epipolar_distance(rays1[None, :, :, None, :], E[:, :, None, None],
                                rays2s[:, :, None, :, :])
    mask = (epi < epi_th) & free1[None, :, :, None] & free2s[:, :, None, :]
    d = torch.where(mask, ham, torch.full_like(ham, BIGD))
    idx2 = torch.argmin(d, dim=3)                                     # [J, C, K]
    best = torch.gather(d, 3, idx2[..., None])[..., 0]
    second = torch.scatter(d, 3, idx2[..., None], BIGD).amin(dim=3)
    ok = (best <= th_desc) & (best < ratio * second)
    idx1 = torch.argmin(d, dim=2)                                     # [J, C, K2]
    ok = ok & (torch.gather(idx1, 2, idx2) == torch.arange(K, device=d.device))
    if check_rotation and ang1 is not None:
        dangle = (ang1[None] - torch.gather(ang2s, 2, idx2)).reshape(J, C * K)
        ok = rotation_consistency(dangle, ok.reshape(J, C * K)).reshape(J, C, K)
    # triangulate in the world frame
    o1 = MtMc1[:, :3, 3][None, :, None, :]                           # [1, C, 1, 3]
    o2 = MtMc2[..., :3, 3][:, :, None, :]                            # [J, C, 1, 3]
    d1w = torch.einsum("cij,ckj->cki", MtMc1[:, :3, :3], rays1)[None]
    r2_sel = torch.gather(rays2s, 2, idx2[..., None].expand(-1, -1, -1, 3))
    d2w = torch.einsum("jcil,jckl->jcki", MtMc2[..., :3, :3], r2_sel)
    X, lam1, lam2 = triangulate_midpoint(o1, d1w, o2, d2w)            # [J, C, K, 3]
    ok = ok & (lam1 > 0) & (lam2 > 0)
    ok = ok & (torch.sum(d1w * d2w, dim=-1) < MAX_PARALLAX_COS)       # parallax
    # reprojection gates in both keyframes through the observing cameras
    Xc1 = transform_points(hom_inverse(MtMc1)[None, :, None], X)
    Xc2 = transform_points(hom_inverse(MtMc2)[:, :, None], X)
    uv1p = intr_project(intr[:, None, :], Xc1)
    uv2p = intr_project(intr[:, None, :], Xc2)
    uv2_sel = torch.gather(uv2s, 2, idx2[..., None].expand(-1, -1, -1, 2))
    ok = ok & (torch.linalg.vector_norm(uv1p - uv1[None], dim=-1) < REPROJ_TH)
    ok = ok & (torch.linalg.vector_norm(uv2p - uv2_sel, dim=-1) < REPROJ_TH)
    ok = ok & (Xc1[..., 2] > 0) & (Xc2[..., 2] > 0)
    dist1 = torch.linalg.vector_norm(X - o1, dim=-1)                  # distance gate
    dist2 = torch.linalg.vector_norm(X - o2, dim=-1)
    ok = ok & (dist1 > 0) & (dist1 < MAX_DIST) & (dist2 > 0) & (dist2 < MAX_DIST)
    cam_base = (torch.arange(C, device=d.device) * K)[None, :, None]
    feat1 = torch.arange(C * K, device=d.device)
    feat2 = (cam_base + idx2).reshape(J, C * K)
    Xf, okf = X.reshape(J, C * K, 3), ok.reshape(J, C * K)
    packed = torch.cat([Xf, feat2[..., None].to(torch.float32), okf[..., None].to(torch.float32)], dim=-1)
    return TriangulationOut(Xf, feat1, feat2, okf, packed)


def triangulate_pair(mc6, pose1, pose2, uv1, rays1, desc1, free1, uv2, rays2, desc2, free2, intr,
                     epi_th: float = 1e-2, th_desc: float = 64.0, ratio: float = 0.8,
                     ang1=None, ang2=None, dmask1=None, dmask2=None, check_rotation: bool = False,
                     use_masks: bool = False) -> TriangulationOut:
    """`triangulate_pairs` for one neighbour: outputs without the J axis."""
    out = triangulate_pairs(mc6, pose1, pose2[None], uv1, rays1, desc1, free1, uv2[None], rays2[None],
                            desc2[None], free2[None], intr, epi_th, th_desc, ratio, ang1,
                            None if ang2 is None else ang2[None], dmask1,
                            None if dmask2 is None else dmask2[None], check_rotation, use_masks)
    return TriangulationOut(out.X[0], out.feat1, out.feat2[0], out.ok[0], out.packed[0])


def fuse_match(mc6, intr, cams, feats: FrameFeatures, pose, pts: LocalPoints, radius: float = 3.0,
               use_masks: bool = False, match_fn: Callable = masked_best_match_cams):
    """Project `pts` into every camera of the (tiled) rig and match with the
    best-match kernel at TH_LOW (x0.5 with the mdBRIEF masks,
    cORBmatcher.cpp:46-65). Returns (assign, dist, keep, packed [3, C*K]
    f32: the three stacked for one readback)."""
    th = (1.0 if use_masks else 2.0) * pts.desc.shape[-1]   # TH_LOW
    assign, dist, keep = project_and_match(mc6, intr, cams, feats, pose, pts, radius=radius, th_desc=th,
                                           use_masks=use_masks, match_fn=match_fn)
    packed = torch.stack([assign.to(torch.float32), dist, keep.to(torch.float32)])
    return assign, dist, keep, packed


class _NullLock:
    """No-op context manager: the sequential pipeline needs no locking."""

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class LocalMapper:
    """Host orchestration of the local-mapping pipeline over a MapStore.
    `match_fn` is the best-match kernel's wrapper (or its plain version)
    that fusion matches with; `use_masks` turns on the mdBRIEF masked
    distance at x0.5 thresholds in triangulation and fusion. `lock` (the
    system's map lock in async mode) is held for store bookkeeping and
    commits only; `yield_gate`, when set, is called before each device
    launch."""

    # a forced (non-interruptible) local BA at least every N keyframes under
    # sustained queue pressure (see run)
    MAX_BA_DEFERRALS = 3

    def __init__(self, store: MapStore, rig: MultiCamRig, match_fn: Callable = masked_best_match_cams,
                 lock=None, use_masks: bool = False):
        self.store = store
        self.use_masks = use_masks
        self.rig = rig
        self.device = rig.Mc.device
        self.mc6 = rig.Mc_cayley.to(torch.float32)
        self.intr = rig.cams.to_vector()
        self.recent_points: List[Tuple[int, int]] = []  # (pt_id, created_kf)
        self.lock = lock if lock is not None else _NullLock()
        self.yield_gate: Optional[Callable[[], None]] = None
        self.match_fn = match_fn
        # consecutive keyframes whose BA was deferred by interrupt pressure
        self._ba_deferred = 0

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=self.device)

    def _yield(self):
        if self.yield_gate is not None:
            self.yield_gate()

    # ------------------------------------------------------------------
    def process_new_keyframe(self, k: int):
        """ProcessNewMultiKeyFrame (cLocalMapping.cpp:145-186): refresh the
        stats of the points the new keyframe observes and attach it to the
        covisibility spanning tree."""
        pts = self.store.kf_point[k]
        self.store.update_point_stats_many(pts[pts >= 0])
        self.store.assign_parent(k)

    # ------------------------------------------------------------------
    def cull_map_points(self, current_kf: int):
        """MapPointCulling (cLocalMapping.cpp:187-222)."""
        s = self.store
        keep = []
        for p, created in self.recent_points:
            if not s.pt_valid[p]:
                continue
            found_ratio = s.pt_found[p] / max(s.pt_visible[p], 1)
            age = current_kf - created
            if found_ratio < FOUND_RATIO_MIN:
                s.erase_point(p)
            elif age >= 2 and s.point_n_obs(p) <= 2:
                s.erase_point(p)
            elif age >= 3:
                pass  # graduated: no longer monitored
            else:
                keep.append((p, created))
        self.recent_points = keep

    # ------------------------------------------------------------------
    def create_new_points(self, k: int, n_neighbors: int = 5) -> int:
        """CreateNewMapPoints (cLocalMapping.cpp:224-387): triangulate k
        against its best covisible neighbours (baseline / median-depth gate
        first). Snapshot under the lock; the pairs on the device without it
        (every pair in one launch, or chunks of 2 under the yield gate),
        launched first and read back after; the new points committed under
        the lock, skipping a feature claimed meanwhile."""
        s = self.store
        C, K = s.cfg.n_cams, s.cfg.feats_per_cam
        th = (1.0 if self.use_masks else 2.0) * s.cfg.desc_bytes   # TH_LOW
        with self.lock:
            if not s.kf_valid[k]:
                return 0
            pose1 = s.kf_pose[k].copy()
            pairs = []
            for j in s.best_covisible(k, n_neighbors):
                b = np.linalg.norm(pose1[3:] - s.kf_pose[j][3:])
                med_depth = self._median_depth(j)
                if med_depth <= 0 or b / med_depth < MIN_BASELINE_DEPTH_RATIO:
                    continue
                pairs.append(int(j))
            if not pairs:
                return 0
            js = np.asarray(pairs)
            rows = np.concatenate([[k], js])
            free = (s.kf_point[rows] == BAD_ID) & s.kf_feat_valid[rows]
            snap = dict(free1=free[0].reshape(C, K), free2=free[1:].reshape(-1, C, K),
                        uv1=s.kf_uv[k].reshape(C, K, 2).copy(), rays1=s.kf_rays[k].reshape(C, K, 3).copy(),
                        desc1=s.kf_desc[k].reshape(C, K, -1).copy(), ang1=s.kf_angle[k].reshape(C, K).copy(),
                        dmask1=s.kf_dmask[k].reshape(C, K, -1).copy(),
                        poses2=s.kf_pose[js], uv2=s.kf_uv[js].reshape(-1, C, K, 2),
                        rays2=s.kf_rays[js].reshape(-1, C, K, 3), desc2=s.kf_desc[js].reshape(len(js), C, K, -1),
                        ang2=s.kf_angle[js].reshape(-1, C, K), dmask2=s.kf_dmask[js].reshape(len(js), C, K, -1))
        chunk = 2 if self.yield_gate is not None else len(pairs)

        def launch(sl):
            self._yield()
            return triangulate_pairs(
                self.mc6, self._t(pose1), self._t(snap["poses2"][sl]),
                self._t(snap["uv1"]), self._t(snap["rays1"]), self._t(snap["desc1"]), self._t(snap["free1"]),
                self._t(snap["uv2"][sl]), self._t(snap["rays2"][sl]), self._t(snap["desc2"][sl]),
                self._t(snap["free2"][sl]), self.intr, th_desc=th,
                ang1=self._t(snap["ang1"]), ang2s=self._t(snap["ang2"][sl]),
                dmask1=self._t(snap["dmask1"]), dmask2s=self._t(snap["dmask2"][sl]), check_rotation=True,
                use_masks=self.use_masks,
            ).packed
        outs = [launch(slice(i0, i0 + chunk)) for i0 in range(0, len(pairs), chunk)]
        packed = np.concatenate([o.cpu().numpy() for o in outs])          # [J, CK, 5]
        created = 0
        new_ids: List[int] = []
        with self.lock:
            if not s.kf_valid[k]:
                return 0
            for i, j in enumerate(pairs):
                if not s.kf_valid[j]:
                    continue
                X, f2 = packed[i, :, :3], packed[i, :, 3].astype(np.int64)
                for f1 in np.nonzero(packed[i, :, 4] > 0.5)[0]:
                    if s.kf_point[k, f1] != BAD_ID or s.kf_point[j, f2[f1]] != BAD_ID:
                        continue  # claimed by an earlier pair or the tracker
                    p = s.add_point(X[f1], s.kf_desc[k, f1], s.kf_dmask[k, f1], first_kf=k,
                                    normal=np.zeros(3, np.float32), min_dist=0.1, max_dist=MAX_DIST)
                    s.add_observation(k, int(f1), p)
                    s.add_observation(j, int(f2[f1]), p)
                    new_ids.append(p)
                    self.recent_points.append((p, k))
                    created += 1
            if new_ids:
                s.update_point_stats_many(np.asarray(new_ids))
        return created

    def _median_depth(self, k: int) -> float:
        """ComputeSceneMedianDepth (cMultiKeyFrame.cpp:756): median depth of
        the keyframe's points in its body frame."""
        s = self.store
        pts = s.kf_point[k]
        pts = np.unique(pts[pts >= 0])
        if len(pts) == 0:
            return -1.0
        Mt = cayley_to_hom_np(s.kf_pose[k])
        Xb = (s.pt_X[pts] - Mt[:3, 3]) @ Mt[:3, :3]
        return float(np.median(np.linalg.norm(Xb, axis=-1)))

    # ------------------------------------------------------------------
    def fuse_neighbors(self, k: int, radius: float = 3.0) -> int:
        """SearchInNeighbors (cLocalMapping.cpp:388-458): project k's points
        into its 1st- and 2nd-ring neighbours and fuse duplicate
        observations. Each target keyframe's body pose folds into its
        cameras' extrinsics (Mc' = Mt_j Mc_c, identity body pose), so the
        targets x C cameras are one tiled rig: one K1 launch for all of them,
        or one a group of 6 under the yield gate. Snapshot, launches and
        commit as in create_new_points."""
        s = self.store
        C, K = s.cfg.n_cams, s.cfg.feats_per_cam
        with self.lock:
            if not s.kf_valid[k]:
                return 0
            ring1 = s.best_covisible(k, 10)
            targets = set(ring1)
            for j in ring1:
                targets.update(s.best_covisible(j, 5))
            targets.discard(k)
            pts = s.kf_point[k]
            pts = np.unique(pts[pts >= 0])
            tj = np.asarray([j for j in sorted(targets) if s.kf_valid[j]], np.int64)
            if len(pts) == 0 or len(tj) == 0:
                return 0
            J = len(tj)
            lp_np = dict(X=s.pt_X[pts], desc=s.pt_desc[pts], min_dist=s.pt_min_dist[pts],
                         max_dist=s.pt_max_dist[pts], normal=s.pt_normal[pts], dmask=s.pt_dmask[pts])
            t_np = dict(pose=s.kf_pose[tj], uv=s.kf_uv[tj].reshape(J * C, K, 2),
                        octave=s.kf_octave[tj].reshape(J * C, K), angle=s.kf_angle[tj].reshape(J * C, K),
                        rays=s.kf_rays[tj].reshape(J * C, K, 3), desc=s.kf_desc[tj].reshape(J * C, K, -1),
                        dmask=s.kf_dmask[tj].reshape(J * C, K, -1), valid=s.kf_feat_valid[tj].reshape(J * C, K))
        lp = LocalPoints(X=self._t(lp_np["X"]), desc=self._t(lp_np["desc"]), min_dist=self._t(lp_np["min_dist"]),
                         max_dist=self._t(lp_np["max_dist"]),
                         valid=torch.ones(len(pts), dtype=torch.bool, device=self.device),
                         normal=self._t(lp_np["normal"]), dmask=self._t(lp_np["dmask"]))
        Mc = self.rig.Mc.cpu().numpy().astype(np.float64)
        mc_eff = hom_to_cayley_np(cayley_to_hom_np(t_np["pose"])[:, None] @ Mc[None]).reshape(J * C, 6)
        group = 6 if self.yield_gate is not None else J

        def launch(g0):
            n, rows = min(group, J - g0), slice(g0 * C, (g0 + group) * C)
            feats = FrameFeatures(
                uv=self._t(t_np["uv"][rows]),
                response=torch.zeros((n * C, K), dtype=torch.float32, device=self.device),
                octave=self._t(t_np["octave"][rows]), angle=self._t(t_np["angle"][rows]),
                rays=self._t(t_np["rays"][rows]), desc=self._t(t_np["desc"][rows]),
                dmask=self._t(t_np["dmask"][rows]), valid=self._t(t_np["valid"][rows]))
            self._yield()
            return fuse_match(self._t(mc_eff[rows]), self.intr.repeat(n, 1), self.rig.cams.tile(n), feats,
                              torch.zeros(6, dtype=torch.float32, device=self.device), lp, radius,
                              use_masks=self.use_masks, match_fn=self.match_fn)[3]
        outs = [launch(g0) for g0 in range(0, J, group)]
        packed = np.concatenate([o.cpu().numpy() for o in outs], axis=1)   # [3, J*C*K]
        assign_all = packed[0].astype(np.int64).reshape(J, C * K)
        keep_all = (packed[2] > 0.5).reshape(J, C * K)
        fused = 0
        touched: List[int] = []
        with self.lock:
            for i, j in enumerate(tj):
                if not s.kf_valid[j]:
                    continue
                for f in np.nonzero(keep_all[i])[0]:
                    p = int(pts[assign_all[i, f]])
                    if not s.pt_valid[p]:
                        continue
                    existing = s.kf_point[j, f]
                    if existing == BAD_ID:
                        s.add_observation(j, int(f), p)
                        touched.append(p)
                        fused += 1
                    elif existing != p and s.pt_valid[existing]:
                        # keep the point with more observations (Fuse)
                        if s.point_n_obs(existing) >= s.point_n_obs(p):
                            s.replace_point(p, int(existing))
                        else:
                            s.replace_point(int(existing), p)
                        fused += 1
            if touched:
                s.update_point_stats_many(np.asarray(touched))
        return fused

    # ------------------------------------------------------------------
    def local_ba(self, k: int, max_iters: int = 10, interrupt=None):
        """LocalBundleAdjustment (cOptimizer.cpp:489-909): free = k and its
        covisible neighbourhood, anchors = the other keyframes that observe
        the local points. The gather and the write-back hold the lock; the
        LM solve runs without it, abortable between chunks by `interrupt`
        (5 iterations a chunk, or 1 under the yield gate)."""
        with self.lock:
            prob = self._gather_local_ba(k)
        if prob is None:
            return
        out, obs = self._solve_ba(prob, max_iters, interrupt)
        with self.lock:
            self._writeback_ba(prob, out, obs)

    def _gather_local_ba(self, k: int):
        s = self.store
        local = [k] + s.best_covisible(k, 20)
        local_set = set(local)
        pts = s.kf_point[np.asarray(local)]
        pts = np.unique(pts[pts >= 0])
        obs_mask = np.isin(s.kf_point, pts) & (s.kf_point >= 0)
        observers = np.nonzero(obs_mask.any(axis=1) & s.kf_valid)[0]
        anchors = [int(j) for j in observers if int(j) not in local_set]
        # always anchor keyframe 0 (the gauge)
        if 0 in local_set and len(local) > 1:
            local.remove(0)
            anchors.append(0)
        # monocular scale gauge: one fixed pose leaves the scale free, so
        # anchor at least two keyframes (the oldest local ones, never k)
        while len(anchors) < 2 and len(local) > 1:
            oldest = min(j for j in local if j != k)
            local.remove(oldest)
            anchors.append(oldest)
        return s.ba_problem(np.asarray(local), np.asarray(anchors, np.int64))

    def problem_tensors(self, prob):
        """A ba_problem dict -> (BAParams, Observations, FreeMask) on the device."""
        nK, nP, nO = len(prob["kf_ids"]), len(prob["pt_ids"]), len(prob["obs_kf"])
        params = BAParams(self._t(prob["poses"]), self._t(prob["points"]), self.mc6, self.intr)
        obs = Observations(self._t(prob["obs_kf"], torch.int64), self._t(prob["obs_pt"], torch.int64),
                           self._t(prob["obs_cam"], torch.int64), self._t(prob["obs_uv"]),
                           self._t(prob["obs_inv_sigma2"]),
                           torch.ones(nO, dtype=torch.bool, device=self.device))
        free = FreeMask(poses=torch.arange(nK, device=self.device) < prob["n_free_kf"],
                        points=torch.ones(nP, dtype=torch.bool, device=self.device))
        return params, obs, free

    def _solve_ba(self, prob, max_iters: int, interrupt=None):
        params, obs, free = self.problem_tensors(prob)
        gated = self.yield_gate is not None
        out, _ = bundle_adjust_interruptible(params, obs, free, max_iters=max_iters, cg_iters=16 if gated else 24,
                                             interrupt=interrupt, chunk_iters=1 if gated else 5,
                                             pre_step=self._yield)
        return out, obs

    def _writeback_ba(self, prob, out: BAParams, obs: Observations):
        s = self.store
        # prune outlier observations (chi2 pass, :798-860)
        valid = prune_observations(out, obs).cpu().numpy()
        for i in np.nonzero(~valid)[0]:
            kf_g, f = int(prob["obs_kf_global"][i]), int(prob["obs_feat"][i])
            if s.kf_point[kf_g, f] >= 0:
                s.erase_observation(kf_g, f)
        s.write_back(prob, poses=out.poses.cpu().numpy(), points=out.points.cpu().numpy())

    # ------------------------------------------------------------------
    def cull_keyframes(self, k: int):
        """KeyFrameCulling (cLocalMapping.cpp:520-597): a covisible keyframe
        goes when >= 90 % of its points are seen >= KF_REDUNDANT_OBS times
        elsewhere at the same or a finer scale."""
        s = self.store
        for j in s.best_covisible(k, 10):
            if j == 0 or not s.kf_valid[j]:
                continue  # never cull the origin anchor
            feats = np.nonzero(s.kf_point[j] >= 0)[0]
            if len(feats) < 20:
                continue
            n_better = native.redundancy_counts(s.kf_point, s.kf_octave, s.kf_valid, int(j))
            ok = s.pt_valid[s.kf_point[j, feats]]
            redundant = int(((n_better[feats] >= KF_REDUNDANT_OBS) & ok).sum())
            if redundant > KF_REDUNDANT_FRAC * len(feats):
                s.erase_keyframe(j)

    # ------------------------------------------------------------------
    def run(self, k: int, do_ba: bool = True, interrupt=None) -> int:
        """One pass of the mapping pipeline for new keyframe k.
        `interrupt()` (optional) is true when a newer keyframe waits or the
        tracker asked for an insertion (InterruptBA, cLocalMapping.cpp:515):
        the reference's backlog order (:69-129) then triangulates always,
        fuses only when nothing newer waits, and defers BA, except that a
        BA is forced after MAX_BA_DEFERRALS deferrals in a row."""
        with self.lock:
            if not self.store.kf_valid[k]:
                return 0  # culled while queued
            self.process_new_keyframe(k)
            self.cull_map_points(k)
        n_new = self.create_new_points(k)
        if not (interrupt is not None and interrupt()):
            self.fuse_neighbors(k)
        force_ba = self._ba_deferred >= self.MAX_BA_DEFERRALS
        skip_ba = interrupt is not None and interrupt() and not force_ba
        if do_ba and self.store.kf_valid.sum() >= 3 and not skip_ba:
            self._ba_deferred = 0
            self.local_ba(k, interrupt=interrupt)
            with self.lock:
                self.cull_keyframes(k)   # KeyFrameCulling follows BA (:100-104)
        elif do_ba:
            self._ba_deferred += 1
        return n_new
