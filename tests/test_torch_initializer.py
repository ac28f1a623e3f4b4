"""Port parity of the map bootstrap: `bootstrap`, `calibrate_metric_scale`
and `downselect_features` against the JAX package, and the init bank of
`extract_features` (2x features at FAST threshold 5).

The bootstrap runs on oracle-feature pairs of a 'line' world (the world of
tests/test_slam_e2e.py), with the RANSAC hypotheses that the JAX package's
`sample_indices(fold_in(key, c), 256, 8, N)` draws for camera c, so both
sides fit the same hypotheses. Then: the same `ok`, `leading_cam` and
`n_total`, Mt2 within 1e-3, feat1 / feat2 equal on >= 99 % of rows; the
metric scale within one step of the fine grid and its inlier count within
1 %; `downselect_features` exactly equal. The init bank is held to the
tolerances of tests/test_torch_extract.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.io.render import render_frame
from multicol_slam_tpu.io.synthetic import make_world
from multicol_slam_tpu.ops import fast as jfast
from multicol_slam_tpu.ops import ransac as jransac
from multicol_slam_tpu.slam import features as jfeatures
from multicol_slam_tpu.slam import initializer as jinit
from multicol_slam_tpu.slam.features import extract_features_jit
from multicol_slam_tpu.utils.config import ExtractorSettings as JSettings
from multicol_slam_tpu_torch import convert
from multicol_slam_tpu_torch.ops import fast as tfast
from multicol_slam_tpu_torch.slam import initializer as tinit
from multicol_slam_tpu_torch.slam.features import (
    FIELDS, ExtractorTables, downselect_features, extract_features,
)
from multicol_slam_tpu_torch.utils.config import ExtractorSettings

KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module")
def world():
    return make_world(n_points=500, n_frames=8, n_cams=2, n_feats=250, noise_px=0.2,
                      trajectory="line", seed=1)


def _rig(jrig):
    c = jrig.cams
    return convert.rig_from_numpy(*(np.asarray(getattr(c, k)) for k in ("pol", "invpol", "cde", "pp", "wh")),
                                  np.asarray(jrig.Mc_cayley), device="cpu")


def _fields(f):
    return {k: np.asarray(getattr(f, k)) for k in FIELDS}


def _jax_sampler(key):
    """The hypotheses the JAX bootstrap draws for camera c."""
    return lambda c, n: torch.tensor(np.asarray(jransac.sample_indices(jax.random.fold_in(key, c), 256, 8, n)))


def _pair(world, t):
    f1, f2 = world.frame_features(0), world.frame_features(t)
    return (f1, f2, convert.frame_features_from_numpy(**_fields(f1), device="cpu"),
            convert.frame_features_from_numpy(**_fields(f2), device="cpu"))


@pytest.mark.parametrize("t", [1, 3, 6])
def test_bootstrap_parity(world, t):
    j1, j2, t1, t2 = _pair(world, t)
    rj, nj = jinit.bootstrap(world.rig, j1, j2, key=KEY)
    rt, nt = tinit.bootstrap(_rig(world.rig), t1, t2, sampler=_jax_sampler(KEY))
    assert nt == nj and nj >= 100
    assert (rt is None) == (rj is None)
    if t == 1:  # one frame of baseline: the parallax gate holds both back
        assert rj is None
        return
    assert rt.ok and rt.leading_cam == rj.leading_cam
    np.testing.assert_allclose(rt.Mt2, rj.Mt2, rtol=0, atol=1e-3)
    for a, b in ((rt.feat1, rj.feat1), (rt.feat2, rj.feat2)):
        n = max(len(a), len(b))
        assert len(set(a.tolist()) ^ set(b.tolist())) <= 0.01 * n, (len(a), len(b))
    assert abs(rt.n_matches - rj.n_matches) <= 0.01 * rj.n_matches
    # a far point's depth amplifies the pose's float32 differences: hold the median
    shared, ia, ib = np.intersect1d(rt.feat1, rj.feat1, return_indices=True)
    rel = np.linalg.norm(rt.points_cam[ia] - rj.points_cam[ib], axis=1) / np.linalg.norm(rj.points_cam[ib], axis=1)
    assert np.median(rel) < 1e-2, np.median(rel)
    # the same points carried to the world frame by both packages
    np.testing.assert_allclose(tinit.points_to_world(_rig(world.rig), rj.leading_cam, rj.points_cam),
                               jinit.points_to_world(world.rig, rj.leading_cam, rj.points_cam),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("t", [3, 6])
def test_calibrate_metric_scale_parity(world, t):
    j1, j2, t1, t2 = _pair(world, t)
    rj, _ = jinit.bootstrap(world.rig, j1, j2, key=KEY)
    sj, nj = jinit.calibrate_metric_scale(world.rig, j1, j2, rj)
    trig = _rig(world.rig)
    # the coarse grid's step; the fine grid's 64 scales span two of them
    fine_step = ((20.0 / 0.05) ** (1.0 / 95)) ** (2.0 / 63)
    # the same bootstrap result on both sides (InitResult has the same fields)
    st, nt = tinit.calibrate_metric_scale(trig, t1, t2, tinit.InitResult(*rj))
    assert nj >= 50 and sj != 1.0
    assert abs(np.log(st / sj)) <= np.log(fine_step) * 1.001, (st, sj)
    assert abs(nt - nj) <= 0.01 * nj, (nt, nj)
    # and chained from the port's own bootstrap
    rt, _ = tinit.bootstrap(trig, t1, t2, sampler=_jax_sampler(KEY))
    st2, nt2 = tinit.calibrate_metric_scale(trig, t1, t2, rt)
    assert abs(np.log(st2 / sj)) <= np.log(fine_step) * 1.001, (st2, sj)
    assert abs(nt2 - nj) <= 0.01 * nj, (nt2, nj)


def test_scale_scores_chunking_changes_nothing(world, monkeypatch):
    j1, j2, t1, t2 = _pair(world, 6)
    trig = _rig(world.rig)
    rt, _ = tinit.bootstrap(trig, t1, t2, sampler=_jax_sampler(KEY))
    a = tinit.calibrate_metric_scale(trig, t1, t2, rt)
    calls = []
    split = torch.split
    monkeypatch.setattr(tinit.torch, "split", lambda x, n: calls.append(n) or split(x, n))
    monkeypatch.setattr(tinit, "SCALE_CHUNK", 5)
    b = tinit.calibrate_metric_scale(trig, t1, t2, rt)
    assert calls == [5, 5] and a == b


@pytest.fixture(scope="module")
def init_bank(world):
    """JAX init-bank features (2 x 128 at FAST 5, 4 levels) of a rendered frame."""
    js = JSettings(n_features=128, n_levels=4, scale_factor=1.2, fast_th=20)
    return _fields(extract_features_jit(jnp.asarray(render_frame(world, 0)), world.rig.cams, js,
                                        n_features=256, fast_th=5.0)), js


@pytest.mark.parametrize("with_keep,with_quotas", [(True, True), (False, True), (True, False)])
def test_downselect_features_exact(init_bank, with_keep, with_quotas):
    f, js = init_bank
    C, K2 = f["valid"].shape
    rng = np.random.default_rng(4)
    keep = np.sort(rng.choice(np.nonzero(f["valid"].reshape(-1))[0], 60, replace=False)) if with_keep else None
    quotas = jfast.level_quota(js.n_features, js.n_levels, js.scale_factor) if with_quotas else None
    jf, jremap = jfeatures.downselect_features(jfeatures.FrameFeatures(**{k: jnp.asarray(v) for k, v in f.items()}),
                                               128, keep=keep, quotas=quotas)
    tf, tremap = downselect_features(convert.frame_features_from_numpy(**f, device="cpu"), 128, keep=keep, quotas=quotas)
    np.testing.assert_array_equal(tremap, jremap)
    for k in FIELDS:
        a, b = getattr(tf, k).numpy(), np.asarray(getattr(jf, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert tf.valid.shape == (C, 128) and int(tf.valid.sum()) > 0.9 * C * 128
    if with_keep:
        assert (tremap[keep] >= 0).all()


@pytest.mark.parametrize("source", ["rendered", "noise"])
def test_init_bank_extraction(world, source):
    """extract_features(n_features=2x, fast_th=5), the bootstrap's bank, with
    the tolerances of tests/test_torch_extract.py: level 0 exact, >= 99 %
    keypoint agreement, >= 99 % equal descriptor bits on shared keypoints."""
    if source == "rendered":
        images = render_frame(world, 2)
    else:
        images = np.random.default_rng(11).integers(0, 256, (2, 192, 256), dtype=np.uint8)
    C, H, W = images.shape
    js = JSettings(n_features=128, n_levels=4, scale_factor=1.2, fast_th=20)
    ts = ExtractorSettings(n_features=128, n_levels=4, scale_factor=1.2, fast_th=20)
    fj = _fields(extract_features_jit(jnp.asarray(images), world.rig.cams, js, n_features=256, fast_th=5.0))
    ft = extract_features(torch.tensor(images), _rig(world.rig).cams, ts, ExtractorTables(ts, H, W, device="cpu"),
                          n_features=256, fast_th=5.0)
    assert ft.uv.shape == (C, 256, 2)
    ft = {k: getattr(ft, k).numpy() for k in fj}
    n_kp, n_shared, bits, bits_equal = 0, 0, 0, 0
    for c in range(C):
        key = lambda f, i: (int(f["octave"][c, i]), float(f["uv"][c, i, 0]), float(f["uv"][c, i, 1]))  # noqa: E731
        kj = {key(fj, i): i for i in np.nonzero(fj["valid"][c])[0]}
        kt = {key(ft, i): i for i in np.nonzero(ft["valid"][c])[0]}
        shared = kj.keys() & kt.keys()
        n_kp += max(len(kj), len(kt))
        n_shared += len(shared)
        for k in shared:
            i, j = kj[k], kt[k]
            x = np.unpackbits(fj["desc"][c, i] ^ ft["desc"][c, j])
            bits += x.size
            bits_equal += x.size - int(x.sum())
            np.testing.assert_allclose(ft["rays"][c, j], fj["rays"][c, i], rtol=0, atol=1e-5)
        lvl0 = fj["octave"][c] == 0
        np.testing.assert_array_equal(ft["uv"][c][lvl0], fj["uv"][c][lvl0])
        np.testing.assert_array_equal(ft["valid"][c][lvl0], fj["valid"][c][lvl0])
        np.testing.assert_array_equal(ft["response"][c][lvl0], fj["response"][c][lvl0])
    assert n_kp > 0.5 * C * 256
    assert n_shared >= 0.99 * n_kp, f"keypoint agreement {n_shared}/{n_kp}"
    assert bits_equal >= 0.99 * bits, f"descriptor bit agreement {bits_equal}/{bits}"
    np.testing.assert_array_equal(tfast.level_quota(256, 4, 1.2), jfast.level_quota(256, 4, 1.2))
