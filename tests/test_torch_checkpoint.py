"""Map checkpoints: the port's `io/checkpoint` against the JAX package's.

The two packages write the same format and read each other's files: a
store saved by one loads in the other with every array and every metadata
value equal (exactly: the arrays are copied, not computed). The zip
members of `np.savez_compressed` carry timestamps, so the bytes of two
files of the same store are not compared. Also: a store that grew past its
initial capacity loads at the grown capacity, `recount_obs` rebuilds the
observation counts (pt_nobs is not saved), a file without a field loads
with the store's initial values for it, and a file of another
descriptor-pipeline version loads with a warning.
"""
import json
import warnings

import numpy as np
import pytest

from multicol_slam_tpu.io import checkpoint as jckpt
from multicol_slam_tpu.slam.map_store import MapConfig as JMapConfig
from multicol_slam_tpu.slam.map_store import MapStore as JMapStore
from multicol_slam_tpu_torch.io import checkpoint as tckpt
from multicol_slam_tpu_torch.io.synthetic import make_world
from multicol_slam_tpu_torch.slam import features as tfeatures
from multicol_slam_tpu_torch.slam.map_store import MapConfig, MapStore

CFG = dict(max_keyframes=8, max_points=64, n_cams=2, feats_per_cam=16, n_levels=4, scale_factor=1.2, desc_bytes=32)
META = ("config", "n_kf", "n_pt_alloc", "free_pt", "free_kf", "loop_edges", "desc_version")


def _filled(store_cls, cfg_cls, seed=0):
    """A store of either package whose every saved field holds seeded
    random values of its dtype, with free lists and loop edges."""
    rng = np.random.default_rng(seed)
    s = store_cls(cfg_cls(**CFG))
    for f in tckpt._ARRAY_FIELDS:
        a = getattr(s, f)
        if a.dtype == bool:
            a[...] = rng.random(a.shape) < 0.6
        elif f == "kf_point":
            a[...] = rng.integers(-1, CFG["max_points"], a.shape)
        elif np.issubdtype(a.dtype, np.integer):
            a[...] = rng.integers(-1, 200, a.shape) if a.dtype != np.uint8 else rng.integers(0, 256, a.shape)
        else:
            a[...] = rng.normal(size=a.shape)
    s.n_kf, s.n_pt_alloc = 7, 60
    s._free_kf, s._free_pt = [2, 5], [3, 11, 40]
    s.loop_edges = [(6, 1), (4, 0)]
    return s


def _same_store(a, b):
    for f in tckpt._ARRAY_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert vars(a.cfg) == vars(b.cfg)
    assert (a.n_kf, a.n_pt_alloc, a._free_kf, a._free_pt) == (b.n_kf, b.n_pt_alloc, b._free_kf, b._free_pt)
    assert [tuple(e) for e in a.loop_edges] == [tuple(e) for e in b.loop_edges]
    np.testing.assert_array_equal(a.pt_nobs, b.pt_nobs)


def _meta(path):
    with np.load(path) as d:
        return json.loads(str(d["__meta__"]))


def test_descriptor_version_is_the_reference_s():
    from multicol_slam_tpu.slam.features import DESC_PIPELINE_VERSION

    assert tfeatures.DESC_PIPELINE_VERSION == DESC_PIPELINE_VERSION == 2


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cross_loading(writer, tmp_path):
    """A file written by one package loads in both, equal to the store that
    was saved (its pt_nobs recounted) and to each other; the two packages'
    files of the same store hold the same members and metadata."""
    port, jax_store = _filled(MapStore, MapConfig), _filled(JMapStore, JMapConfig)
    port.recount_obs()
    jax_store.recount_obs()
    paths = {"port": str(tmp_path / "port.npz"), "jax": str(tmp_path / "jax.npz")}
    tckpt.save_map(paths["port"], port)
    jckpt.save_map(paths["jax"], jax_store)
    loaded_t, loaded_j = tckpt.load_map(paths[writer]), jckpt.load_map(paths[writer])
    assert isinstance(loaded_t, MapStore) and isinstance(loaded_j, JMapStore)
    _same_store(loaded_t, port)
    _same_store(loaded_j, port)
    assert loaded_t._covis_cache == {}
    mp, mj = _meta(paths["port"]), _meta(paths["jax"])
    assert set(mp) == set(META) and mp == mj
    with np.load(paths["port"]) as a, np.load(paths["jax"]) as b:
        assert sorted(a.files) == sorted(b.files) == sorted(tckpt._ARRAY_FIELDS + ["__meta__"])
        for f in tckpt._ARRAY_FIELDS:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_grown_store_loads_at_its_capacity(tmp_path):
    """Keyframes past max_keyframes double the store (its cfg too); the
    checkpoint loads at the grown capacity in both packages."""
    world = make_world(n_points=80, n_frames=6, n_cams=2, n_feats=16, seed=4)
    s = MapStore(MapConfig(**dict(CFG, max_keyframes=4)))
    for t in range(6):
        k = s.add_keyframe(world.poses[t], world.frame_features(t, device="cpu"), float(t), t)
        p = s.add_point(world.points[t], world.descs[t], np.full(32, 255, np.uint8), first_kf=k,
                        normal=np.zeros(3, np.float32), min_dist=0.1, max_dist=25.0)
        s.add_observation(k, 0, p)
    assert s.cfg.max_keyframes == 8
    path = str(tmp_path / "grown.npz")
    tckpt.save_map(path, s)
    for loaded in (tckpt.load_map(path), jckpt.load_map(path)):
        assert loaded.cfg.max_keyframes == 8 and loaded.kf_pose.shape == (8, 6)
        assert int(loaded.kf_valid.sum()) == 6
        np.testing.assert_array_equal(loaded.kf_point, s.kf_point)
        np.testing.assert_array_equal(loaded.pt_nobs, s.pt_nobs)


def test_recount_obs_matches_the_maintained_count():
    world = make_world(n_points=80, n_frames=3, n_cams=2, n_feats=16, seed=5)
    s = MapStore(MapConfig(**CFG))
    ks = [s.add_keyframe(world.poses[t], world.frame_features(t, device="cpu"), float(t), t) for t in range(3)]
    ps = [s.add_point(world.points[i], world.descs[i], np.full(32, 255, np.uint8), first_kf=0,
                      normal=np.zeros(3, np.float32), min_dist=0.1, max_dist=25.0) for i in range(10)]
    for i, p in enumerate(ps):
        for k in ks[: 1 + i % 3]:
            s.add_observation(k, i, p)
    s.erase_observation(ks[0], 1)
    s.replace_point(ps[2], ps[3])
    maintained = s.pt_nobs.copy()
    s.pt_nobs[:] = 99
    s.recount_obs()
    np.testing.assert_array_equal(s.pt_nobs, maintained)
    j = JMapStore(JMapConfig(**CFG))
    j.kf_point[...] = s.kf_point
    j.recount_obs()
    np.testing.assert_array_equal(j.pt_nobs, maintained)


def _meta_of(s):
    return dict(config=vars(s.cfg).copy(), n_kf=s.n_kf, n_pt_alloc=s.n_pt_alloc, free_pt=s._free_pt,
                free_kf=s._free_kf, loop_edges=s.loop_edges, desc_version=tfeatures.DESC_PIPELINE_VERSION)


def test_missing_field_and_version_warning(tmp_path):
    """A file without kf_parent and stamped with descriptor pipeline v1:
    both packages load it with kf_parent at its initial value and warn."""
    s = _filled(MapStore, MapConfig)
    path = str(tmp_path / "old.npz")
    meta = _meta_of(s)
    meta["desc_version"] = 1
    np.savez_compressed(path, __meta__=json.dumps(meta),
                        **{f: getattr(s, f) for f in tckpt._ARRAY_FIELDS if f != "kf_parent"})
    fresh_stores = (MapStore(MapConfig(**CFG)), JMapStore(JMapConfig(**CFG)))
    for load, fresh in zip((tckpt.load_map, jckpt.load_map), fresh_stores):
        with pytest.warns(UserWarning, match="descriptor-pipeline v1"):
            loaded = load(path)
        np.testing.assert_array_equal(loaded.kf_parent, fresh.kf_parent)
        np.testing.assert_array_equal(loaded.kf_point, s.kf_point)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tckpt.save_map(str(tmp_path / "now.npz"), s)
        tckpt.load_map(str(tmp_path / "now.npz"))
