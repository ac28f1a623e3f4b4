"""Port parity of the bootstrap's relative-pose solver: `ransac_essential`,
fed the hypotheses that the JAX package's `sample_indices` draws, against
the JAX `ransac_essential` with the same key; and its parts.

The SVD's signs and the order of the four (R, t) candidates may differ
between LAPACK builds, so the winner is compared, not the factors: R and t
(unit norm, same sign) within 1e-3, the inlier masks >= 99 % equal and
n_inliers within 1 %. Triangulation, the model error and the depths'
numerators within 1e-5 of the largest magnitude."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.io.synthetic import make_world
from multicol_slam_tpu.ops import ransac as jransac
from multicol_slam_tpu.utils.geometry import triangulate_midpoint as jax_triangulate
from multicol_slam_tpu_torch.ops import ransac as transac
from multicol_slam_tpu_torch.utils.geometry import triangulate_midpoint


def _rot(rng, deg):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    a = np.radians(deg)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K


def _scene(seed, n=300, outliers=0.2, noise=1e-3, deg=3.0):
    """Rays of n points seen from two views, X2 = R X1 + t, with angular
    noise and a share of random outlier rays in view 2."""
    rng = np.random.default_rng(seed)
    X1 = rng.uniform([-4, -4, 2], [4, 4, 10], (n, 3))
    R = _rot(rng, deg)
    t = rng.normal(size=3)
    t = 0.4 * t / np.linalg.norm(t)
    X2 = X1 @ R.T + t
    r1 = X1 / np.linalg.norm(X1, axis=1, keepdims=True) + rng.normal(0, noise, (n, 3))
    r2 = X2 / np.linalg.norm(X2, axis=1, keepdims=True) + rng.normal(0, noise, (n, 3))
    bad = rng.uniform(size=n) < outliers
    r2[bad] = rng.normal(size=(bad.sum(), 3))
    r1 /= np.linalg.norm(r1, axis=1, keepdims=True)
    r2 /= np.linalg.norm(r2, axis=1, keepdims=True)
    return r1.astype(np.float32), r2.astype(np.float32), R, t / np.linalg.norm(t)


def _world_pair():
    """Matched rays of one camera between frames 0 and 8 of a 'line' world
    (the oracle features carry the landmark identity)."""
    w = make_world(n_points=400, n_frames=10, n_cams=3, n_feats=250, noise_px=0.3,
                   trajectory="line", seed=2)
    from multicol_slam_tpu.slam.tracking_kernels import match_window_frames

    f1, f2 = w.frame_features(0), w.frame_features(8)
    idx = np.asarray(match_window_frames(f1, f2, radius=100.0, th_desc=64.0, ratio=0.9)[0])
    sel = np.nonzero(idx[0] >= 0)[0]
    return np.asarray(f1.rays)[0][sel], np.asarray(f2.rays)[0][idx[0][sel]]


CASES = ["scene0", "scene1", "scene_small_motion", "world_line"]


def _case(name):
    if name == "world_line":
        return _world_pair()
    if name == "scene_small_motion":
        return _scene(7, n=250, outliers=0.1, deg=0.5)[:2]
    return _scene(int(name[-1]))[:2]


@pytest.mark.parametrize("name", CASES)
def test_ransac_essential_same_winner(name):
    r1, r2 = _case(name)
    n = len(r1)
    valid = np.ones(n, bool)
    valid[-5:] = False
    key = jax.random.fold_in(jax.random.PRNGKey(3), 1)
    ref = jransac.ransac_essential(key, jnp.asarray(r1), jnp.asarray(r2), jnp.asarray(valid))
    idx = np.asarray(jransac.sample_indices(key, 256, 8, n))
    got = transac.ransac_essential(torch.tensor(r1), torch.tensor(r2), torch.tensor(valid),
                                   idx=torch.tensor(idx))
    n_ref, n_got = int(ref.n_inliers), int(got.n_inliers)
    assert n_ref >= 0.5 * n, f"the reference finds the model ({n_ref}/{n})"
    assert abs(n_got - n_ref) <= 0.01 * n_ref, (n_got, n_ref)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=0, atol=1e-3)
    assert abs(float(torch.linalg.vector_norm(got.t)) - 1.0) < 1e-5
    agree = float((got.inliers.numpy() == np.asarray(ref.inliers)).mean())
    assert agree >= 0.99, agree
    assert float(got.score) == n_got and not got.inliers.numpy()[-5:].any()


def test_ransac_essential_recovers_the_motion():
    r1, r2, R, t = _scene(5)
    got = transac.ransac_essential(torch.tensor(r1), torch.tensor(r2), torch.ones(len(r1), dtype=torch.bool),
                                   generator=torch.Generator().manual_seed(0))
    assert np.degrees(np.arccos(np.clip((np.trace(got.R.numpy().T @ R) - 1) / 2, -1, 1))) < 0.5
    assert float(got.t.numpy() @ t) > 0.99


def test_sample_indices_generator():
    g = torch.Generator().manual_seed(5)
    a = transac.sample_indices(256, 8, 37, g)
    b = transac.sample_indices(256, 8, 37, torch.Generator().manual_seed(5))
    assert a.shape == (256, 8) and a.dtype == torch.int64 and torch.equal(a, b)
    assert int(a.min()) == 0 and int(a.max()) == 36
    assert int(transac.sample_indices(4, 8, 0, g).max()) == 0


@pytest.mark.parametrize("async_mapping", [False, True])
def test_system_draws_on_a_cpu_generator_whatever_its_device(async_mapping):
    """The system's RANSAC hypotheses (bootstrap, relocalization, the loop's
    Sim3, the async worker's) come from CPU generators seeded with its seed,
    on any device: a CUDA generator of the same seed draws another stream,
    and the card's eval --mdbrief seed 8 parted from the CPU's there (11 vs
    22 of 25 frames tracked). A system on the meta device stands in for the
    card here (a generator cannot be made on it)."""
    from multicol_slam_tpu_torch.io.synthetic import make_synthetic_rig
    from multicol_slam_tpu_torch.slam.map_store import MapConfig
    from multicol_slam_tpu_torch.slam.system import MultiColSLAM
    from multicol_slam_tpu_torch.utils.config import ExtractorSettings, SlamSettings

    slam = MultiColSLAM(make_synthetic_rig(2, device="meta"),
                        SlamSettings(extractor=ExtractorSettings(n_features=50, n_levels=1)),
                        MapConfig(max_keyframes=4, max_points=16, n_cams=2, feats_per_cam=50, n_levels=1),
                        device="meta", seed=3, async_mapping=async_mapping)
    try:
        for g in (slam.generator, slam.loop_closer.generator):
            assert g.device.type == "cpu" and g.initial_seed() == 3
        assert (slam.loop_closer.generator is slam.generator) != async_mapping
    finally:
        slam.shutdown()


def test_eight_point_and_candidates_match_up_to_sign():
    """On exact correspondences E is unique up to sign, and the four (R, t)
    candidates are the same set."""
    r1, r2, R, t = _scene(9, n=40, outliers=0.0, noise=0.0)
    rows = np.arange(40).reshape(5, 8)
    Ej = np.asarray(jransac._eight_point(jnp.asarray(r1[rows]), jnp.asarray(r2[rows])))
    Et = transac._eight_point(torch.tensor(r1[rows]), torch.tensor(r2[rows])).numpy()
    for a, b in zip(Et, Ej):
        s = np.sign(np.sum(a * b))
        np.testing.assert_allclose(a, s * b, rtol=0, atol=1e-4)
    Rj, tj = (np.asarray(x) for x in jransac.decompose_essential(jnp.asarray(Ej)))
    Rt, tt = (x.numpy() for x in transac.decompose_essential(torch.tensor(Ej)))
    for s in range(len(Ej)):
        for k in range(4):
            d = [np.abs(Rt[s, k] - Rj[s, m]).max() + np.abs(tt[s, k] - tj[s, m]).max() for m in range(4)]
            assert min(d) < 1e-4
        # one candidate is the true motion
        assert min(np.abs(Rt[s, k] - R).max() + np.abs(tt[s, k] - t).max() for k in range(4)) < 1e-3


@pytest.mark.parametrize("seed", [0, 1])
def test_triangulate_and_model_error(seed):
    rng = np.random.default_rng(seed)
    o1 = rng.normal(size=(200, 3)).astype(np.float32)
    o2 = rng.normal(size=(200, 3)).astype(np.float32)
    d1 = rng.normal(size=(200, 3))
    d2 = rng.normal(size=(200, 3))
    d1 = (d1 / np.linalg.norm(d1, axis=1, keepdims=True)).astype(np.float32)
    d2 = (d2 / np.linalg.norm(d2, axis=1, keepdims=True)).astype(np.float32)
    ref = jax_triangulate(*(jnp.asarray(x) for x in (o1, d1, o2, d2)))
    got = triangulate_midpoint(*(torch.tensor(x) for x in (o1, d1, o2, d2)))
    for a, b in zip(got, ref):
        _close_rel(a.numpy(), np.asarray(b))
    # the model error of candidates near the true motion of a scene, and of its four
    # chirality candidates (as RANSAC scores them)
    r1, r2, R, t = _scene(seed, n=150, outliers=0.0)
    R4 = np.stack([R @ _rot(rng, 0.2 * k) for k in range(4)]).astype(np.float32)
    t4 = t + rng.normal(0, 0.02, (4, 3))
    t4 = (t4 / np.linalg.norm(t4, axis=1, keepdims=True)).astype(np.float32)
    R4, t4 = np.concatenate([R4, R4[:2]]), np.concatenate([t4, -t4[:2]])
    ref = jransac._triangulation_error(*(jnp.asarray(x) for x in (R4, t4, r1, r2)))
    got = transac._triangulation_error(*(torch.tensor(x) for x in (R4, t4, r1, r2)))
    _close_rel(got[0].numpy(), np.asarray(ref[0]))
    # a depth is the 2x2 solve's numerator over 1 - cos^2(parallax), which
    # amplifies float32 rounding by 1 / (1 - cos^2): compare numerators, and signs
    d2 = np.einsum("sji,nj->sni", R4.astype(np.float64), r2)
    denom = 1.0 - np.sum(r1 * d2, axis=-1) ** 2
    for a, b in zip(got[1:], ref[1:]):
        a, b = a.numpy(), np.asarray(b)
        _close_rel(a * denom, b * denom)
        assert (np.sign(a) == np.sign(b)).all()


def _close_rel(a, b, rel=1e-5):
    """max |a - b| <= rel * max |b|: float32 sums in another order, no more."""
    assert a.shape == b.shape
    err = float(np.abs(a.astype(np.float64) - b).max())
    assert err <= rel * float(np.abs(b).max()), (err, float(np.abs(b).max()))
