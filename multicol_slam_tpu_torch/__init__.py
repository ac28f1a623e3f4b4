"""MultiCol-SLAM in PyTorch + CUDA for NVIDIA Hopper (H100).

A port of the JAX package `multicol_slam_tpu`, which stays the reference.
Modules and functions keep the reference's names, so each counterpart is
found at the same path under `multicol_slam_tpu/`. This package imports
torch and numpy only: never jax, never `multicol_slam_tpu`, never yaml.

Ported so far:
- the per-frame tracking step of a running system,
  `slam.features.extract_features` -> `slam.tracking_kernels.track_frame_fused`;
- the map bootstrap of an initializing system: the init-bank extraction,
  `slam.initializer.bootstrap` (`match_window_frames`, `ops.ransac.ransac_essential`,
  the CheckRT and parallax gates), `calibrate_metric_scale` and
  `slam.features.downselect_features`; and the synthetic world and renderer
  (`io.synthetic`, `io.render`) that feed it;
- the running system in sync mode, `slam.system.MultiColSLAM.track`: the
  map store, local mapping and BA after each keyframe, then loop closing
  (`slam.loop_closing`, `models.vocab`), and relocalization when LOST.

TPU kernels of the reference (every `pl.pallas_call`) and their state here:

| Kernel | reference | port |
|---|---|---|
| K1 `masked_best_match_pallas_cams` | `ops/pallas_match.py:200`, call `:361`, bodies `:305-340` | CUDA C++ `csrc/best_match.cu` (`mcslam_best_match`), wrapper `ops/best_match.masked_best_match_cams` |
| K2 `masked_best_match_pallas` | `ops/pallas_match.py:113`, call `:163`, body `:45-98` | CUDA C++ `csrc/best_match.cu` (`mcslam_best_match_single`), wrapper `ops/best_match.masked_best_match` |

On a CPU tensor each kernel wrapper runs its plain PyTorch version; on a
CUDA tensor it launches the hand-written kernel or raises.
"""
