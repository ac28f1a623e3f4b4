"""The port's MapStore against the JAX package's: the same sequence of
operations on both gives equal arrays (exactly: the store is host numpy on
both sides, and the port's scans are the same C code). The sequence grows
both capacities, erases, replaces and recycles slots, rebuilds the
spanning tree, and exports and writes back a BA problem."""
import dataclasses

import numpy as np
import pytest

from multicol_slam_tpu.slam import map_store as jms
from multicol_slam_tpu.slam.features import FrameFeatures as JFeatures
from multicol_slam_tpu_torch import convert
from multicol_slam_tpu_torch.slam import map_store as tms

CFG = dict(max_keyframes=4, max_points=16, n_cams=2, feats_per_cam=10, n_levels=3, scale_factor=1.2,
           desc_bytes=32)


def _features(rng):
    C, K = CFG["n_cams"], CFG["feats_per_cam"]
    rays = rng.normal(size=(C, K, 3)).astype(np.float32)
    f = dict(uv=rng.uniform(0, 200, (C, K, 2)).astype(np.float32), response=rng.uniform(size=(C, K)),
             octave=rng.integers(0, 3, (C, K)), angle=rng.uniform(0, 6, (C, K)),
             rays=rays / np.linalg.norm(rays, axis=-1, keepdims=True),
             desc=rng.integers(0, 256, (C, K, 32), dtype=np.uint8),
             dmask=np.full((C, K, 32), 255, np.uint8), valid=rng.uniform(size=(C, K)) < 0.9)
    return JFeatures(**f), convert.frame_features_from_numpy(**f, device="cpu")


def _assert_same(js, ts):
    for name, a in vars(js).items():
        if name.startswith(("kf_", "pt_")) and isinstance(a, np.ndarray):
            b = getattr(ts, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert (js.n_kf, js.n_pt_alloc, js._free_kf, js._free_pt) == (ts.n_kf, ts.n_pt_alloc, ts._free_kf,
                                                                 ts._free_pt)
    assert dataclasses.asdict(js.cfg) == dataclasses.asdict(ts.cfg)


@pytest.fixture
def stores():
    return jms.MapStore(jms.MapConfig(**CFG)), tms.MapStore(tms.MapConfig(**CFG))


def test_same_operations_same_arrays(stores):
    js, ts = stores
    rng = np.random.default_rng(0)
    F = CFG["n_cams"] * CFG["feats_per_cam"]
    # six keyframes: past the keyframe capacity of 4
    for k in range(6):
        jf, tf = _features(rng)
        pose = rng.normal(0, 0.3, 6).astype(np.float32)
        assert js.add_keyframe(pose, jf, 0.04 * k, k) == ts.add_keyframe(pose, tf, 0.04 * k, k)
    _assert_same(js, ts)
    # forty points (past the point capacity of 16), two to four observations each
    for _ in range(40):
        X = rng.normal(0, 3, 3).astype(np.float32)
        k0, f0 = int(rng.integers(0, 6)), int(rng.integers(0, F))
        args = (X, js.kf_desc[k0, f0], js.kf_dmask[k0, f0], k0, np.zeros(3, np.float32), 0.1, 25.0)
        p = js.add_point(*args)
        assert ts.add_point(*args) == p
        for k in rng.choice(6, int(rng.integers(2, 5)), replace=False):
            f = int(rng.integers(0, F))
            js.add_observation(int(k), f, p)
            ts.add_observation(int(k), f, p)
    for s in stores:
        s.update_point_stats_many(np.arange(40))
        for k in range(6):
            s.assign_parent(k)
    _assert_same(js, ts)
    for k in range(6):
        assert js.covisibility(k) == ts.covisibility(k)
        assert js.best_covisible(k, 3) == ts.best_covisible(k, 3)
    # erase, replace, recycle
    for s in stores:
        s.erase_observation(1, int(np.nonzero(s.kf_point[1] >= 0)[0][0]))
        s.erase_point(5)
        s.replace_point(7, 9)
        s.replace_point(12, 3)
        s.erase_keyframe(2)
        s.update_point_stats_many(np.arange(40))
    _assert_same(js, ts)
    jf, tf = _features(rng)
    pose = rng.normal(0, 0.3, 6).astype(np.float32)
    assert js.add_keyframe(pose, jf, 1.0, 10) == ts.add_keyframe(pose, tf, 1.0, 10) == 2   # the freed slot
    X = np.ones(3, np.float32)
    assert js.add_point(X, js.pt_desc[0], js.pt_dmask[0], 2, X, 0.1, 25.0) == \
        ts.add_point(X, ts.pt_desc[0], ts.pt_dmask[0], 2, X, 0.1, 25.0)
    for s in stores:
        s.add_observation(2, 3, 0)
        s.assign_parent(2)
    _assert_same(js, ts)
    np.testing.assert_array_equal(js.kf_parent, ts.kf_parent)
    # BA export and write-back
    pj = js.ba_problem(np.array([3, 4]), np.array([0, 1]))
    pt = ts.ba_problem(np.array([3, 4]), np.array([0, 1]))
    assert pj.keys() == pt.keys()
    for key in pj:
        np.testing.assert_array_equal(pj[key], pt[key], err_msg=key)
    poses = pj["poses"] + 0.01
    points = pj["points"] - 0.02
    js.write_back(pj, poses=poses, points=points)
    ts.write_back(pt, poses=poses, points=points)
    _assert_same(js, ts)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_point_stats_match_the_reference_loop(seed):
    """update_point_stats_many (grouped by observation count in the port,
    point by point in the reference) on points seen by 1-12 keyframes with
    random stability masks and octaves: the same arrays, to the bit."""
    cfg = dict(CFG, max_keyframes=16, max_points=300, feats_per_cam=40, n_levels=4)
    js, ts = jms.MapStore(jms.MapConfig(**cfg)), tms.MapStore(tms.MapConfig(**cfg))
    rng = np.random.default_rng(seed)
    C, K, F = cfg["n_cams"], cfg["feats_per_cam"], cfg["n_cams"] * cfg["feats_per_cam"]
    for k in range(12):
        rays = rng.normal(size=(C, K, 3)).astype(np.float32)
        f = dict(uv=rng.uniform(0, 200, (C, K, 2)).astype(np.float32), response=rng.uniform(size=(C, K)),
                 octave=rng.integers(0, 4, (C, K)), angle=rng.uniform(0, 6, (C, K)),
                 rays=rays / np.linalg.norm(rays, axis=-1, keepdims=True),
                 desc=rng.integers(0, 256, (C, K, 32), dtype=np.uint8),
                 dmask=rng.integers(0, 256, (C, K, 32), dtype=np.uint8), valid=np.ones((C, K), bool))
        pose = rng.normal(0, 2.0, 6).astype(np.float32)
        js.add_keyframe(pose, JFeatures(**f), 0.04 * k, k)
        ts.add_keyframe(pose, convert.frame_features_from_numpy(**f, device="cpu"), 0.04 * k, k)
    for i in range(250):
        X = rng.normal(0, 5, 3).astype(np.float32)
        args = (X, js.kf_desc[0, i % F], js.kf_dmask[0, i % F], 0, np.zeros(3, np.float32), 0.1, 25.0)
        p = js.add_point(*args)
        assert ts.add_point(*args) == p
        for k in rng.choice(12, int(rng.integers(1, 13)), replace=False):
            f = int(rng.integers(0, F))
            if js.kf_point[k, f] < 0:
                js.add_observation(int(k), f, p)
                ts.add_observation(int(k), f, p)
    js.update_point_stats_many(np.arange(250))
    ts.update_point_stats_many(np.arange(250))
    _assert_same(js, ts)
    assert len(np.unique(ts.pt_nobs[:250])) >= 10


@pytest.mark.parametrize("name", ["cayley_to_rot_np", "cayley_to_hom_np", "rot_to_cayley_np", "hom_to_cayley_np",
                                  "hom_inverse_np"])
def test_pose_helpers_equal(name):
    """The store's numpy pose helpers, batched and single, exactly."""
    rng = np.random.default_rng(2)
    c6 = rng.normal(0, 0.5, (5, 6)).astype(np.float32)
    arg = {"cayley_to_rot_np": c6[:, :3], "cayley_to_hom_np": c6}.get(name)
    if arg is None:
        M = jms.cayley_to_hom_np(c6)
        arg = M[:, :3, :3] if name == "rot_to_cayley_np" else M
    for a in (arg, arg[0]):
        np.testing.assert_array_equal(getattr(tms, name)(a), getattr(jms, name)(a))


def test_map_store_from_numpy_round_trip(stores):
    """A JAX store carried into the port by convert.map_store_from_numpy
    equals it and goes on equal under the same operations."""
    js, _ = stores
    rng = np.random.default_rng(1)
    for k in range(3):
        jf, _ = _features(rng)
        js.add_keyframe(np.zeros(6, np.float32), jf, 0.0, k)
    for i in range(8):
        p = js.add_point(np.ones(3, np.float32) * i, js.kf_desc[0, i], js.kf_dmask[0, i], 0,
                         np.zeros(3, np.float32), 0.1, 25.0)
        js.add_observation(0, i, p)
        js.add_observation(1, i + 1, p)
    js.erase_point(3)
    arrays = {k: v for k, v in vars(js).items() if k.startswith(("kf_", "pt_")) and isinstance(v, np.ndarray)}
    ts = convert.map_store_from_numpy(dataclasses.asdict(js.cfg), arrays, js.n_kf, js.n_pt_alloc,
                                      js._free_kf, js._free_pt)
    _assert_same(js, ts)
    for s in (js, ts):
        s.update_point_stats_many(np.arange(8))
        s.erase_keyframe(1)
    _assert_same(js, ts)
    with pytest.raises(ValueError):
        convert.map_store_from_numpy(dataclasses.asdict(js.cfg), {"scale_factors": np.ones(3)}, 0, 0, [], [])


def test_erased_keyframe_leaves_the_covisibility_cache():
    """Erasing a keyframe with spanning-tree children re-homes them by their
    covisibility, computed while the keyframe is still valid; afterwards no
    keyframe may name the erased one as covisible. (The JAX package keeps
    the children's entries until the next insert, and its CorrectLoop then
    fails on the erased keyframe's missing pose snapshot.)"""
    ts = tms.MapStore(tms.MapConfig(**CFG))
    rng = np.random.default_rng(4)
    for k in range(3):
        ts.add_keyframe(np.zeros(6, np.float32), _features(rng)[1], 0.04 * k, k)
    # points seen by all three keyframes: 1 and 2 covisible with 0 and each other
    for f in range(6):
        p = ts.add_point(rng.normal(0, 3, 3).astype(np.float32), ts.kf_desc[0, f], ts.kf_dmask[0, f], 0,
                         np.zeros(3, np.float32), 0.1, 25.0)
        for k in range(3):
            ts.add_observation(k, f, p)
    ts.assign_parent(1)
    ts.kf_parent[2] = 1                 # 2 is a child of 1
    assert ts.kf_parent[1] == 0 and 1 in ts.covisibility(2)
    ts.erase_keyframe(1)
    assert not ts.kf_valid[1] and ts.kf_parent[2] == 0
    assert 1 not in ts.covisibility(2) and 1 not in ts.covisibility(0)
    assert set(ts.covisibility(2)) == {0}
