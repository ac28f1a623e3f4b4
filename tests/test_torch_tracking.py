"""Port parity of the whole slice: `track_frame_fused` (both tracking stages)
against the JAX package, at a small shape (3 cameras of 192 x 256, 128
features, 4 levels, a local map of 512 points).

Given identical features, the assignment and the inlier mask agree exactly,
and the pose within 1e-4. From images end to end, each side extracts its
own features (a few keypoints differ at pyramid levels >= 1, see
test_torch_extract.py), so the pose agrees within 1e-3 and the inlier count
within max(2, 2 %)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.io.synthetic import make_world
from multicol_slam_tpu.slam.features import extract_features_jit
from multicol_slam_tpu.slam.tracking_kernels import LocalPoints as JPoints
from multicol_slam_tpu.slam.tracking_kernels import track_frame_fused as jax_track
from multicol_slam_tpu.slam.tracking_kernels import unpack_fused as jax_unpack
from multicol_slam_tpu.utils.config import ExtractorSettings as JSettings
from multicol_slam_tpu_torch import convert
from multicol_slam_tpu_torch.slam.features import ExtractorTables, extract_features
from multicol_slam_tpu_torch.slam.tracking_kernels import track_frame_fused, unpack_fused
from multicol_slam_tpu_torch.utils.config import ExtractorSettings

C, H, W, L = 3, 192, 256, 512
FIELDS = ("uv", "response", "octave", "angle", "rays", "desc", "dmask", "valid")
DPOSE = np.array([0.002, -0.003, 0.002, 0.02, -0.015, 0.01], np.float32)


@pytest.fixture(scope="module")
def world():
    return make_world(n_points=L, n_frames=2, n_cams=C, n_feats=128, seed=0)


def _rig(jrig):
    c = jrig.cams
    return convert.rig_from_numpy(
        *(np.asarray(getattr(c, k)) for k in ("pol", "invpol", "cde", "pp", "wh")),
        np.asarray(jrig.Mc_cayley), device="cpu")


def _both(arrays):
    """The same local map for both packages."""
    jp = JPoints(**{k: (None if v is None else jnp.asarray(v)) for k, v in arrays.items()})
    return jp, convert.local_points_from_numpy(**arrays, device="cpu")


def _run(jrig, trig, jfeats, tfeats, pose, jpts, tpts, **kw):
    mc6 = jnp.asarray(np.asarray(jrig.Mc_cayley, np.float32))
    pj = np.asarray(jax_track(mc6, jnp.asarray(jrig.cams.to_vector()), jrig.cams, jfeats,
                              jnp.asarray(pose), jpts, jpts, **kw))
    pt = track_frame_fused(trig.Mc_cayley, trig.cams.to_vector(), trig.cams, tfeats,
                           torch.tensor(pose), tpts, tpts, **kw)
    assert pt.shape == pj.shape and torch.isfinite(pt).all()
    return jax_unpack(pj), unpack_fused(pt.numpy())


@pytest.mark.parametrize("masked", [False, True], ids=["orb", "masked_normals"])
def test_identical_features(world, masked):
    rng = np.random.default_rng(1)
    arrays = dict(X=world.points[:L].astype(np.float32), desc=world.descs[:L],
                  min_dist=np.full(L, 5.0, np.float32), max_dist=np.full(L, 50.0, np.float32),
                  valid=rng.uniform(size=L) < 0.95)
    wf = world.frame_features(1)
    fields = {k: np.asarray(getattr(wf, k)) for k in FIELDS}
    th = 96.0
    if masked:  # mdBRIEF masks on both sides, and viewing normals (some zero: the gate passes)
        arrays["dmask"] = rng.integers(0, 256, (L, 32), dtype=np.uint8) | 0x0F
        normal = rng.normal(0, 1, (L, 3)).astype(np.float32)
        normal[rng.uniform(size=L) < 0.5] = 0.0
        arrays["normal"] = normal
        fields["dmask"] = rng.integers(0, 256, fields["desc"].shape, dtype=np.uint8) | 0xF0
        th = 48.0
    jfeats = type(wf)(**{k: jnp.asarray(v) for k, v in fields.items()})
    tfeats = convert.frame_features_from_numpy(**fields, device="cpu")
    jpts, tpts = _both(arrays)
    pose = np.asarray(world.poses[1], np.float32) + DPOSE
    uj, ut = _run(world.rig, _rig(world.rig), jfeats, tfeats, pose, jpts, tpts,
                  radius1=15.0, radius2=4.0, th_desc=th, use_masks=masked)
    assert ut[1] == uj[1] and ut[3] == uj[3] and ut[4] == uj[4]
    assert uj[4] >= 20, "the scene must actually track"
    np.testing.assert_array_equal(ut[5], uj[5])   # stage-2 assignment
    np.testing.assert_array_equal(ut[6], uj[6])   # stage-2 inliers
    np.testing.assert_allclose(ut[0], uj[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ut[2], uj[2], rtol=0, atol=1e-4)


def test_end_to_end_from_images(world):
    """The bench.py phase-1 recipe at a small shape: a local map from the
    frame's own keypoints pushed to 3-12 m, tracked from a perturbed pose."""
    jrig = world.rig
    trig = _rig(jrig)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (C, H, W), dtype=np.uint8)
    js = JSettings(n_features=128, n_levels=4, scale_factor=1.2, fast_th=15)
    ts = ExtractorSettings(n_features=128, n_levels=4, scale_factor=1.2, fast_th=15)
    jfeats = extract_features_jit(jnp.asarray(images), jrig.cams, js)
    valid, rays, desc, octave = (np.asarray(getattr(jfeats, k)) for k in ("valid", "rays", "desc", "octave"))
    Mc = np.asarray(jrig.Mc)
    Xs, Ds, Ms = [], [], []
    for c in range(C):
        v = valid[c]
        depth = rng.uniform(3.0, 12.0, v.sum()).astype(np.float32)
        Xs.append((Mc[c, :3, :3] @ (rays[c][v] * depth[:, None]).T).T + Mc[c, :3, 3])
        Ds.append(desc[c][v])
        Ms.append(depth / 1.2 ** octave[c][v])  # predicted level = the detection octave
    X, D, mind = np.concatenate(Xs), np.concatenate(Ds), np.concatenate(Ms)
    n = len(X)
    arrays = dict(X=np.pad(X, ((0, L - n), (0, 0))).astype(np.float32), desc=np.pad(D, ((0, L - n), (0, 0))),
                  min_dist=np.pad(mind, (0, L - n), constant_values=1.0).astype(np.float32),
                  max_dist=np.full(L, 40.0, np.float32), valid=np.arange(L) < n)
    jpts, tpts = _both(arrays)
    tfeats = extract_features(torch.tensor(images), trig.cams, ts, ExtractorTables(ts, H, W, device="cpu"))
    uj, ut = _run(jrig, trig, jfeats, tfeats, DPOSE, jpts, tpts,
                  n_levels=4, radius1=15.0, radius2=4.0, th_desc=96.0)
    assert uj[4] >= 50, f"the scene must actually track ({uj[4]} inliers)"
    assert abs(ut[4] - uj[4]) <= max(2, 0.02 * uj[4]), (ut[4], uj[4])
    np.testing.assert_allclose(ut[2], uj[2], rtol=0, atol=1e-3)
    np.testing.assert_allclose(ut[0], uj[0], rtol=0, atol=1e-3)
