"""Visualization: map and frame publishers as files (port of
`multicol_slam_tpu/io/viz.py`).

The reference's viewer stack (SURVEY.md §2 rows 20-22) as artifacts:

  cViewer (cViewer.cpp:72-245)            -> Visualizer.update: every N-th
      Pangolin window + per-camera OpenCV     frame's artifacts written to a
      windows, menu toggles                   directory instead of a GL loop
  cMapPublisher (cMapPublisher.cpp:59-423) -> render_map: map points (black),
      points/reference points/KF frusta       reference points (red), per-
      per camera/covisibility/current pose    camera frusta via M_t*M_c,
                                              covisibility lines, current pose
  cMultiFramePublisher (:69-233)           -> render_frame: keypoints and
      keypoints + tracked points + status     tracked points drawn on each
      text per camera                         camera image + status banner

Host-only numpy: PNGs through matplotlib's Agg backend, and `.npz` dumps
(`<path>.npz`) where matplotlib is not installed. The publishers read the
system's state after a frame; they change nothing.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from multicol_slam_tpu_torch.utils.geometry import cayley_to_hom

_STATE_NAMES = {
    0: "NO IMAGES YET",
    1: "NOT INITIALIZED",
    2: "INITIALIZING",
    3: "SLAM ON (WORKING)",
    4: "LOST",
}


def _mpl():
    """matplotlib.pyplot on the Agg backend, or None where it does not import."""
    try:
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        return plt
    except Exception:  # noqa: BLE001 - any failure means no PNGs: the .npz dumps instead
        return None


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _poses_hom(pose6) -> np.ndarray:
    """Cayley poses [..., 6] as 4x4 matrices, on the CPU in float32."""
    return cayley_to_hom(torch.as_tensor(np.asarray(pose6), dtype=torch.float32)).numpy()


def _frustum_lines(MtMc: np.ndarray, scale: float = 0.12) -> np.ndarray:
    """Pyramid frustum edges for one camera pose (the per-camera frusta of
    cMapPublisher::DrawMultiKeyFrames). Returns [n_seg, 2, 3]."""
    w, h, z = 0.8 * scale, 0.5 * scale, 1.0 * scale
    corners = np.array(
        [[0, 0, 0], [w, h, z], [w, -h, z], [-w, -h, z], [-w, h, z]], np.float64
    )
    pts = corners @ MtMc[:3, :3].T + MtMc[:3, 3]
    seg = []
    for i in (1, 2, 3, 4):
        seg.append([pts[0], pts[i]])
    for a, b in ((1, 2), (2, 3), (3, 4), (4, 1)):
        seg.append([pts[a], pts[b]])
    return np.asarray(seg)


def render_map(
    store,
    rig,
    path: str,
    current_pose6: Optional[np.ndarray] = None,
    reference_points: Optional[np.ndarray] = None,
    draw_covisibility: bool = True,
    max_cov_edges: int = 400,
) -> bool:
    """Render the 3-D map top-down and from the side (cMapPublisher).
    Returns False (and writes `path`.npz) when matplotlib is unavailable."""
    kfs = store.active_kfs()
    pts = store.active_points()
    X = store.pt_X[pts] if len(pts) else np.zeros((0, 3))
    poses = _poses_hom(store.kf_pose[kfs]) if len(kfs) else np.zeros((0, 4, 4))
    plt = _mpl()
    if plt is None:
        np.savez(path + ".npz", points=X, kf_poses=poses)
        return False
    fig, axes = plt.subplots(1, 2, figsize=(12, 6))
    Mc = _host(rig.Mc)
    ref_set = set(int(p) for p in (reference_points if reference_points is not None else []))
    ref_mask = np.asarray([int(p) in ref_set for p in pts], bool) if len(pts) else np.zeros(0, bool)
    for ax, (i, j), names in ((axes[0], (0, 1), "xy"), (axes[1], (0, 2), "xz")):
        if len(X):
            ax.scatter(X[~ref_mask, i], X[~ref_mask, j], s=1, c="k", alpha=0.4)
            if ref_mask.any():
                ax.scatter(X[ref_mask, i], X[ref_mask, j], s=2, c="r", alpha=0.7)
        # keyframe frusta per camera (M_t * M_c)
        for Mt in poses:
            for c in range(Mc.shape[0]):
                for seg in _frustum_lines(Mt @ Mc[c]):
                    ax.plot(seg[:, i], seg[:, j], c="b", lw=0.4, alpha=0.6)
        # covisibility graph lines between body centers
        if draw_covisibility and len(kfs) > 1:
            centers = poses[:, :3, 3]
            n_drawn = 0
            for a_idx, a in enumerate(kfs):
                cov = store.covisibility(int(a), min_weight=30)
                for b, w in cov.items():
                    if b <= a:
                        continue
                    b_idx = int(np.searchsorted(kfs, b))
                    if b_idx < len(kfs) and kfs[b_idx] == b:
                        ax.plot(
                            [centers[a_idx, i], centers[b_idx, i]],
                            [centers[a_idx, j], centers[b_idx, j]],
                            c="g", lw=0.5, alpha=0.5,
                        )
                        n_drawn += 1
                if n_drawn > max_cov_edges:
                    break
        # current rig pose (green frusta)
        if current_pose6 is not None:
            Mt = _poses_hom(current_pose6)
            for c in range(Mc.shape[0]):
                for seg in _frustum_lines(Mt @ Mc[c], scale=0.18):
                    ax.plot(seg[:, i], seg[:, j], c="lime", lw=1.0)
        ax.set_xlabel(names[0])
        ax.set_ylabel(names[1])
        ax.set_aspect("equal")
    fig.suptitle(f"{len(pts)} map points, {len(kfs)} keyframes")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return True


def render_frame(
    images: np.ndarray,
    uv: np.ndarray,
    valid: np.ndarray,
    tracked: np.ndarray,
    state: int,
    path: str,
    n_inliers: int = 0,
) -> bool:
    """Draw each camera's keypoints, its tracked points and a status banner
    (cMultiFramePublisher::DrawMultiFrame: green = tracked map point, blue =
    detected keypoint). Returns False (and writes `path`.npz) when
    matplotlib is unavailable."""
    plt = _mpl()
    C = images.shape[0]
    uv = np.asarray(uv).reshape(C, -1, 2)
    valid = np.asarray(valid).reshape(C, -1)
    tracked = np.asarray(tracked).reshape(C, -1)
    if plt is None:
        np.savez(path + ".npz", uv=uv, valid=valid, tracked=tracked)
        return False
    fig, axes = plt.subplots(1, C, figsize=(5 * C, 4.2))
    axes = np.atleast_1d(axes)
    for c in range(C):
        axes[c].imshow(images[c], cmap="gray", vmin=0, vmax=255)
        det = valid[c] & ~tracked[c]
        axes[c].scatter(uv[c, det, 0], uv[c, det, 1], s=4, c="deepskyblue", marker="+")
        trk = valid[c] & tracked[c]
        axes[c].scatter(uv[c, trk, 0], uv[c, trk, 1], s=6, c="lime", marker="o")
        axes[c].set_title(f"cam {c}: {int(trk.sum())} tracked")
        axes[c].set_axis_off()
    fig.suptitle(f"{_STATE_NAMES.get(state, state)} — {n_inliers} inliers")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return True


class Visualizer:
    """The cViewer equivalent: every `every`-th frame, frame_XXXXXX.png (the
    frame publisher) and map_XXXXXX.png (the map publisher) under out_dir.
    Called from the tracking thread after a frame."""

    def __init__(self, out_dir: str, every: int = 25):
        self.out_dir = out_dir
        self.every = max(int(every), 1)
        os.makedirs(out_dir, exist_ok=True)

    def update(self, slam, images, metrics) -> None:
        if metrics.frame_id % self.every:
            return
        feats = slam.last_feats
        if feats is None or images is None:
            return
        assign = slam.last_assign_global
        valid = _host(feats.valid)
        tracked = (assign >= 0) if assign is not None else np.zeros(valid.size, bool)
        render_frame(
            _host(images),
            _host(feats.uv),
            valid,
            tracked,
            metrics.state,
            os.path.join(self.out_dir, f"frame_{metrics.frame_id:06d}.png"),
            n_inliers=metrics.n_inliers,
        )
        with slam.map_lock:
            render_map(
                slam.store,
                slam.rig,
                os.path.join(self.out_dir, f"map_{metrics.frame_id:06d}.png"),
                current_pose6=metrics.pose,
            )
