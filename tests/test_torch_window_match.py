"""Port parity of the bootstrap's window match: `match_window_frames` (two
launches of the best-match kernel, here its plain version on the CPU)
against both branches of the JAX package's, the dense jnp one and the
Pallas K1 one (`MCSLAM_PALLAS=1`, interpret mode), and
`rotation_consistency` on its own.

Inputs: oracle features of a synthetic world (`frame_features`, angles 0)
and features the JAX extractor finds in `render_frame` images (real IC
angles, so the rotation histogram does work), carried into the port. The
match indices must be exactly equal, and the distance wherever matched."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.io.render import render_frame
from multicol_slam_tpu.io.synthetic import make_world
from multicol_slam_tpu.ops.matching import rotation_consistency as jax_rotation_consistency
from multicol_slam_tpu.slam.features import FrameFeatures, extract_features_jit
from multicol_slam_tpu.slam.tracking_kernels import match_window_frames as jax_match
from multicol_slam_tpu.utils.config import ExtractorSettings as JSettings
from multicol_slam_tpu_torch import convert
from multicol_slam_tpu_torch.ops.best_match import KERNEL, masked_best_match_cams_plain
from multicol_slam_tpu_torch.ops.matching import mutual_filter, rotation_consistency
from multicol_slam_tpu_torch.slam.tracking_kernels import match_window_frames

FIELDS = ("uv", "response", "octave", "angle", "rays", "desc", "dmask", "valid")
BRANCHES = ("dense", "pallas")


@pytest.fixture(scope="module", autouse=True)
def _fresh_traces():
    """Later modules must not reuse a trace made under MCSLAM_PALLAS=1."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def world():
    return make_world(n_points=400, n_frames=60, n_cams=3, n_feats=200, noise_px=0.3, seed=4)


def _fields(f):
    return {k: np.asarray(getattr(f, k)) for k in FIELDS}


@pytest.fixture(scope="module")
def pairs(world):
    """(name -> (fields of frame q, fields of frame t))."""
    out = {"oracle": (_fields(world.frame_features(0)), _fields(world.frame_features(1)))}
    js = JSettings(n_features=200, n_levels=4, scale_factor=1.2, fast_th=20)
    rendered = [_fields(extract_features_jit(jnp.asarray(render_frame(world, t)), world.rig.cams, js,
                                             n_features=250, fast_th=5.0)) for t in (0, 1)]
    out["rendered"] = tuple(rendered)
    return out


def _jax(fq, ft, branch, monkeypatch, **kw):
    monkeypatch.setenv("MCSLAM_PALLAS", "1" if branch == "pallas" else "0")
    jax.clear_caches()  # match_window_frames reads use_pallas() at trace time
    jq = FrameFeatures(**{k: jnp.asarray(v) for k, v in fq.items()})
    jt = FrameFeatures(**{k: jnp.asarray(v) for k, v in ft.items()})
    idx, dist = jax_match(jq, jt, **kw)
    return np.asarray(idx), np.asarray(dist)


@pytest.mark.parametrize("branch", BRANCHES)
@pytest.mark.parametrize("source,check_rotation", [("oracle", False), ("oracle", True),
                                                   ("rendered", False), ("rendered", True)])
def test_match_window_frames_exact(pairs, source, check_rotation, branch, monkeypatch):
    fq, ft = pairs[source]
    kw = dict(radius=100.0, th_desc=64.0, ratio=0.9, check_rotation=check_rotation)
    ij, dj = _jax(fq, ft, branch, monkeypatch, **kw)
    before = KERNEL.launches
    it, dt = match_window_frames(convert.frame_features_from_numpy(**fq, device="cpu"),
                                 convert.frame_features_from_numpy(**ft, device="cpu"), **kw)
    assert KERNEL.launches == before  # CPU tensors take the plain version
    it, dt = it.numpy(), dt.numpy()
    np.testing.assert_array_equal(it, ij)
    matched = ij >= 0
    np.testing.assert_array_equal(dt[matched], dj[matched])
    assert matched.sum() >= 100, f"{source}: only {matched.sum()} matches"


def test_match_fn_plain_and_wrapper_agree(pairs):
    fq, ft = (convert.frame_features_from_numpy(**f, device="cpu") for f in pairs["rendered"])
    a = match_window_frames(fq, ft, check_rotation=True)
    b = match_window_frames(fq, ft, check_rotation=True, match_fn=masked_best_match_cams_plain)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_rendered_rotation_check_filters(pairs):
    """Real angles: the histogram check removes some matches, not most."""
    fq, ft = (convert.frame_features_from_numpy(**f, device="cpu") for f in pairs["rendered"])
    n0 = int((match_window_frames(fq, ft)[0] >= 0).sum())
    n1 = int((match_window_frames(fq, ft, check_rotation=True)[0] >= 0).sum())
    assert 0.5 * n0 < n1 <= n0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rotation_consistency_exact(seed):
    rng = np.random.default_rng(seed)
    n = 600
    # a dominant rotation, a second mode, outliers, and values on bin edges and multiples of 2 pi
    dangle = np.concatenate([rng.normal(0.3, 0.05, n // 2), rng.normal(-2.0, 0.05, n // 6),
                             rng.uniform(-7.0, 7.0, n // 6),
                             np.arange(n - n // 2 - 2 * (n // 6)) * (2 * np.pi / 30) - 4 * np.pi])
    dangle = dangle.astype(np.float32)
    ok = rng.uniform(size=n) < 0.8
    ref = np.asarray(jax_rotation_consistency(jnp.asarray(dangle), jnp.asarray(ok)))
    got = rotation_consistency(torch.tensor(dangle), torch.tensor(ok)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < ok.sum()


def test_rotation_consistency_few_bins_exact():
    """Fewer than 3 populated bins, and a lone outlier below 10 % of the top."""
    dangle = np.array([0.1] * 40 + [1.0] * 3 + [3.0], np.float32)
    ok = np.ones(len(dangle), bool)
    ref = np.asarray(jax_rotation_consistency(jnp.asarray(dangle), jnp.asarray(ok)))
    got = rotation_consistency(torch.tensor(dangle), torch.tensor(ok)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not got[-1] and got[:40].all()


def test_mutual_filter_exact():
    from multicol_slam_tpu.ops.matching import mutual_filter as jax_mutual_filter

    rng = np.random.default_rng(3)
    idx_qt = rng.integers(0, 50, 80).astype(np.int32)
    idx_tq = rng.integers(0, 80, 50).astype(np.int32)
    idx_tq[idx_qt[:30]] = np.arange(30)  # some pairs map back
    ok = rng.uniform(size=80) < 0.9
    ref = np.asarray(jax_mutual_filter(jnp.asarray(idx_qt), jnp.asarray(ok), jnp.asarray(idx_tq)))
    got = mutual_filter(torch.tensor(idx_qt), torch.tensor(ok), torch.tensor(idx_tq)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.sum() > 5
