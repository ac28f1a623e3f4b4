"""The port's local mapping against the JAX package's, stage by stage, each
stage started on both sides from one JAX `MapStore` snapshot carried into
the port by `convert.map_store_from_numpy`.

The snapshots come from the JAX system on tests/test_slam_e2e.py's line
world (2 cameras, 250 oracle features, 1 level): the map right before the
bootstrap's cross-camera fusion (`fuse_neighbors` of the second keyframe),
and right before `LocalMapper.run` of the first inserted keyframe.

Exact: every integer and boolean table of the store (observations, point
and keyframe validity, descriptors, octaves, parents) and each stage's
count. Float arrays within 5e-4 relative + 1e-4 absolute: a new point's
midpoint triangulation amplifies the float32 rounding of its rays by
1 / sin^2(parallax), up to ~3300x at the 1-degree parallax gate; after
local BA (10 LM iterations, closed-form against autodiff Jacobians) within
5e-4 relative + 1e-3 absolute."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from multicol_slam_tpu.io.synthetic import make_world
from multicol_slam_tpu.slam import local_mapping as jlm
from multicol_slam_tpu.slam.map_store import MapConfig as JMapConfig
from multicol_slam_tpu.slam.system import MultiColSLAM as JSLAM
from multicol_slam_tpu.utils.config import ExtractorSettings as JExtractor
from multicol_slam_tpu.utils.config import SlamSettings as JSettings
from multicol_slam_tpu_torch import convert
from multicol_slam_tpu_torch.slam import local_mapping as tlm

N_FEATS = 250
MAP = dict(max_keyframes=64, max_points=4000, n_cams=2, feats_per_cam=N_FEATS, n_levels=1, scale_factor=1.2)
FLOATS = {"kf_pose", "kf_uv", "kf_rays", "kf_angle", "kf_timestamp", "pt_X", "pt_normal", "pt_min_dist",
          "pt_max_dist"}


@pytest.fixture(scope="module")
def world():
    return make_world(n_points=500, n_frames=18, n_cams=2, n_feats=N_FEATS, noise_px=0.2,
                      trajectory="line", seed=1)


@pytest.fixture(scope="module")
def snapshots(world):
    """(store, recent_points, k) of the JAX run before the bootstrap's
    fusion ('init') and before the first keyframe's mapping pass ('kf')."""
    slam = JSLAM(world.rig, JSettings(fps=25.0, extractor=JExtractor(n_features=N_FEATS, n_levels=1)),
                 JMapConfig(**MAP), use_loop_closing=False)
    snaps = {}
    mapper = slam.mapper
    fuse, run = mapper.fuse_neighbors, mapper.run

    def fuse_snap(k, *a, **kw):
        snaps.setdefault("init", (copy.deepcopy(slam.store), list(mapper.recent_points), k))
        return fuse(k, *a, **kw)

    def run_snap(k, do_ba=True, **kw):
        if do_ba:
            snaps.setdefault("kf", (copy.deepcopy(slam.store), list(mapper.recent_points), k))
        return run(k, do_ba=do_ba, **kw)

    mapper.fuse_neighbors, mapper.run = fuse_snap, run_snap
    for t in range(len(world.poses)):
        slam.track(feats=world.frame_features(t), timestamp=world.timestamps[t])
        if "kf" in snaps:
            break
    assert set(snaps) == {"init", "kf"}, "the run must reach its first keyframe"
    return snaps


def _rig(jrig):
    c = jrig.cams
    return convert.rig_from_numpy(*(np.asarray(getattr(c, k)) for k in ("pol", "invpol", "cde", "pp", "wh")),
                                  np.asarray(jrig.Mc_cayley), device="cpu")


def _arrays(store):
    return {k: v for k, v in vars(store).items() if k.startswith(("kf_", "pt_")) and isinstance(v, np.ndarray)}


def mappers(world, snap):
    """A JAX LocalMapper on a copy of the snapshot and the port's on its
    conversion, with the snapshot's recent points."""
    store, recent, k = snap
    js = copy.deepcopy(store)
    ts = convert.map_store_from_numpy(dataclasses.asdict(js.cfg), _arrays(js), js.n_kf, js.n_pt_alloc,
                                      js._free_kf, js._free_pt)
    jm, tm = jlm.LocalMapper(js, world.rig), tlm.LocalMapper(ts, _rig(world.rig))
    jm.recent_points, tm.recent_points = list(recent), list(recent)
    return jm, tm, k


def assert_same_store(js, ts, atol=1e-4):
    arrays = _arrays(js)
    for name in sorted(arrays, key=lambda n: n in FLOATS):      # the exact tables first
        a, b = arrays[name], getattr(ts, name)
        if name in FLOATS:
            mask = js.pt_valid if name.startswith("pt_") else js.kf_valid
            np.testing.assert_allclose(b[mask], a[mask], rtol=5e-4, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
    assert (js.n_kf, js.n_pt_alloc, sorted(js._free_kf), sorted(js._free_pt)) == \
        (ts.n_kf, ts.n_pt_alloc, sorted(ts._free_kf), sorted(ts._free_pt))


def test_snapshot_carries_over(world, snapshots):
    for snap in snapshots.values():
        jm, tm, _ = mappers(world, snap)
        assert_same_store(jm.store, tm.store, atol=0)


def test_bootstrap_fusion(world, snapshots):
    """The cross-camera re-observation of the bootstrap (system.py:470)."""
    jm, tm, k = mappers(world, snapshots["init"])
    assert tm.fuse_neighbors(k) == jm.fuse_neighbors(k) > 0
    assert_same_store(jm.store, tm.store)


def _prepare(jm, tm, k):
    for m in (jm, tm):
        m.process_new_keyframe(k)
        m.cull_map_points(k)


def test_process_and_cull(world, snapshots):
    jm, tm, k = mappers(world, snapshots["kf"])
    _prepare(jm, tm, k)
    assert_same_store(jm.store, tm.store)
    assert tm.recent_points == jm.recent_points


def test_triangulate_pairs(world, snapshots):
    """triangulate_pairs over the keyframe's neighbours == the reference's
    vmapped triangulate_pair: the same matches and gates, X within 5e-4
    relative."""
    import jax.numpy as jnp

    jm, tm, k = mappers(world, snapshots["kf"])
    _prepare(jm, tm, k)
    s = jm.store
    C, K = s.cfg.n_cams, s.cfg.feats_per_cam
    js_ = np.asarray(s.best_covisible(k, 5))
    free = (s.kf_point == -1) & s.kf_feat_valid
    a = dict(uv1=s.kf_uv[k].reshape(C, K, 2), rays1=s.kf_rays[k].reshape(C, K, 3),
             desc1=s.kf_desc[k].reshape(C, K, -1), free1=free[k].reshape(C, K),
             uv2s=s.kf_uv[js_].reshape(-1, C, K, 2), rays2s=s.kf_rays[js_].reshape(-1, C, K, 3),
             desc2s=s.kf_desc[js_].reshape(len(js_), C, K, -1), free2s=free[js_].reshape(-1, C, K),
             ang1=s.kf_angle[k].reshape(C, K), ang2s=s.kf_angle[js_].reshape(-1, C, K))
    mc6 = np.asarray(world.rig.Mc_cayley, np.float32)
    intr = np.asarray(world.rig.cams.to_vector())
    ref = jlm.triangulate_pairs(jnp.asarray(mc6), jnp.asarray(s.kf_pose[k]), jnp.asarray(s.kf_pose[js_]),
                                **{n: jnp.asarray(v) for n, v in a.items()}, intr=jnp.asarray(intr),
                                th_desc=64.0, check_rotation=True)
    got = tlm.triangulate_pairs(torch.tensor(mc6), torch.tensor(s.kf_pose[k]), torch.tensor(s.kf_pose[js_]),
                                **{n: torch.tensor(v) for n, v in a.items()}, intr=torch.tensor(intr),
                                th_desc=64.0, check_rotation=True)
    ok = np.asarray(ref.ok)
    np.testing.assert_array_equal(got.ok.numpy(), ok)
    np.testing.assert_array_equal(got.feat2.numpy()[ok], np.asarray(ref.feat2)[ok])
    np.testing.assert_allclose(got.X.numpy()[ok], np.asarray(ref.X)[ok], rtol=5e-4, atol=1e-4)
    one = tlm.triangulate_pair(torch.tensor(mc6), torch.tensor(s.kf_pose[k]), torch.tensor(s.kf_pose[js_[0]]),
                               *(torch.tensor(a[n]) for n in ("uv1", "rays1", "desc1", "free1")),
                               *(torch.tensor(a[n][0]) for n in ("uv2s", "rays2s", "desc2s", "free2s")),
                               torch.tensor(intr), th_desc=64.0, ang1=torch.tensor(a["ang1"]),
                               ang2=torch.tensor(a["ang2s"][0]), check_rotation=True)
    assert torch.equal(one.packed, got.packed[0])


def test_create_new_points(world, snapshots):
    jm, tm, k = mappers(world, snapshots["kf"])
    _prepare(jm, tm, k)
    n = tm.create_new_points(k)
    assert n == jm.create_new_points(k)
    assert_same_store(jm.store, tm.store)
    assert tm.recent_points == jm.recent_points


def test_fuse_match(world, snapshots):
    """fuse_match on the tiled rig (targets x cameras, as fuse_neighbors
    builds it) == the reference's on its jnp.tile'd rig: the same assign,
    dist and keep."""
    import jax
    import jax.numpy as jnp

    from multicol_slam_tpu.slam.features import FrameFeatures as JF
    from multicol_slam_tpu.slam.tracking_kernels import LocalPoints as JLP
    from multicol_slam_tpu_torch.slam.features import FrameFeatures as TF
    from multicol_slam_tpu_torch.slam.tracking_kernels import LocalPoints as TLP

    jm, tm, k = mappers(world, snapshots["kf"])
    s = jm.store
    C, K = s.cfg.n_cams, s.cfg.feats_per_cam
    pts = np.unique(s.kf_point[k][s.kf_point[k] >= 0])
    tj = np.asarray(s.best_covisible(k, 3))
    J = len(tj)
    lp = dict(X=s.pt_X[pts], desc=s.pt_desc[pts], min_dist=s.pt_min_dist[pts], max_dist=s.pt_max_dist[pts],
              valid=np.ones(len(pts), bool), normal=s.pt_normal[pts])
    from multicol_slam_tpu_torch.slam.map_store import cayley_to_hom_np, hom_to_cayley_np

    mc = hom_to_cayley_np(cayley_to_hom_np(s.kf_pose[tj])[:, None] @ np.asarray(world.rig.Mc, np.float64)[None])
    f = dict(uv=s.kf_uv[tj].reshape(J * C, K, 2), response=np.zeros((J * C, K), np.float32),
             octave=s.kf_octave[tj].reshape(J * C, K), angle=s.kf_angle[tj].reshape(J * C, K),
             rays=s.kf_rays[tj].reshape(J * C, K, 3), desc=s.kf_desc[tj].reshape(J * C, K, -1),
             dmask=s.kf_dmask[tj].reshape(J * C, K, -1), valid=s.kf_feat_valid[tj].reshape(J * C, K))
    cams_j = jax.tree_util.tree_map(lambda a: jnp.tile(a, (J,) + (1,) * (a.ndim - 1)), world.rig.cams)
    intr = np.asarray(world.rig.cams.to_vector())
    ref = jlm.fuse_match(jnp.asarray(mc.reshape(-1, 6)), jnp.tile(jnp.asarray(intr), (J, 1)), cams_j,
                         JF(**{n: jnp.asarray(v) for n, v in f.items()}), jnp.zeros(6, jnp.float32),
                         JLP(**{n: jnp.asarray(v) for n, v in lp.items()}), 3.0)
    got = tlm.fuse_match(torch.tensor(mc.reshape(-1, 6)), torch.tensor(intr).repeat(J, 1), tm.rig.cams.tile(J),
                         TF(**{n: torch.tensor(v) for n, v in f.items()}), torch.zeros(6),
                         TLP(**{n: torch.tensor(v) for n, v in lp.items()}), 3.0)
    for name, a, b in zip(("assign", "dist", "keep"), ref[:3], got[:3]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert int(got[2].sum()) > 0


def _after_fusion(world, snapshots):
    jm, tm, k = mappers(world, snapshots["kf"])
    _prepare(jm, tm, k)
    for m in (jm, tm):
        m.create_new_points(k)
    return jm, tm, k


def test_fuse_neighbors(world, snapshots):
    jm, tm, k = _after_fusion(world, snapshots)
    assert tm.fuse_neighbors(k) == jm.fuse_neighbors(k)
    assert_same_store(jm.store, tm.store)


def test_local_ba_and_cull_keyframes(world, snapshots):
    jm, tm, k = _after_fusion(world, snapshots)
    for m in (jm, tm):
        m.fuse_neighbors(k)
    pj, pt = jm._gather_local_ba(k), tm._gather_local_ba(k)
    for key in pj:
        if key in ("poses", "points"):
            np.testing.assert_allclose(pt[key], pj[key], rtol=5e-4, atol=1e-4, err_msg=key)
        else:
            np.testing.assert_array_equal(pt[key], pj[key], err_msg=key)
    jm.local_ba(k)
    tm.local_ba(k)
    assert_same_store(jm.store, tm.store, atol=1e-3)
    assert not np.array_equal(tm.store.kf_pose, mappers(world, snapshots["kf"])[1].store.kf_pose)
    for m in (jm, tm):
        m.cull_keyframes(k)
    assert_same_store(jm.store, tm.store, atol=1e-3)


def test_run(world, snapshots):
    """The whole pass for the keyframe (LocalMapper.run), sequential mode."""
    jm, tm, k = mappers(world, snapshots["kf"])
    assert tm.run(k) == jm.run(k)
    assert_same_store(jm.store, tm.store, atol=1e-3)
