"""Port parity: feature extraction (pyramid, box filter, FAST + NMS, grid
top-K, IC angles, ORB descriptors, rays) against the JAX package, on
uint8 noise images at a small shape (3 x 192 x 256, 128 features, 4 levels).

Level 0 is integer-valued, so FAST corners, scores and the top-K selection
agree exactly there. The pyramid levels come from float32 contractions
summed in another order than JAX's (see ops/image.py), so a few threshold
compares flip at levels >= 1: the whole extraction is held to >= 99 %
keypoint agreement and >= 99 % equal descriptor bits on shared keypoints."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.io.synthetic import make_synthetic_rig
from multicol_slam_tpu.ops import brief as jbrief
from multicol_slam_tpu.ops import fast as jfast
from multicol_slam_tpu.ops import image as jimage
from multicol_slam_tpu.slam.features import extract_features_jit
from multicol_slam_tpu.utils.config import ExtractorSettings as JSettings
from multicol_slam_tpu_torch import convert
from multicol_slam_tpu_torch.ops import brief as tbrief
from multicol_slam_tpu_torch.ops import fast as tfast
from multicol_slam_tpu_torch.ops import image as timage
from multicol_slam_tpu_torch.slam.features import ExtractorTables, extract_features
from multicol_slam_tpu_torch.utils.config import ExtractorSettings

C, H, W = 3, 192, 256
N_FEATS, N_LEVELS, FAST_TH = 128, 4, 15


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(11).integers(0, 256, (C, H, W), dtype=np.uint8)


@pytest.fixture(scope="module")
def rigs():
    jrig = make_synthetic_rig(n_cams=C, w=W, h=H)
    c = jrig.cams
    trig = convert.rig_from_numpy(
        *(np.asarray(getattr(c, k)) for k in ("pol", "invpol", "cde", "pp", "wh")),
        np.asarray(jrig.Mc_cayley), device="cpu")
    return jrig, trig


def test_build_pyramid(images):
    img = images.astype(np.float32)
    pj = jimage.build_pyramid(jnp.asarray(img), N_LEVELS, 1.2)
    pt = timage.build_pyramid(torch.tensor(img), N_LEVELS, 1.2)
    weights = timage.pyramid_weights(H, W, N_LEVELS, 1.2)
    ref64 = [img.astype(np.float64)]
    for wr, wc in weights:
        ref64.append(wr.T.astype(np.float64) @ ref64[-1] @ wc.astype(np.float64))
    for lvl, (a, b, r) in enumerate(zip(pj, pt, ref64)):
        assert b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=2e-2, err_msg=f"level {lvl}")
        np.testing.assert_allclose(b.numpy(), r, rtol=0, atol=1e-3, err_msg=f"level {lvl} vs f64")


def test_box_filter_max_pool_patches(images):
    img = images.astype(np.float32)
    bj = jimage.box_filter(jnp.asarray(img), 5)
    bt = timage.box_filter(torch.tensor(img), 5)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=0, atol=1e-4)
    s = np.where(images > 200, img, -np.inf).astype(np.float32)
    np.testing.assert_array_equal(timage.max_pool_3x3(torch.tensor(s)).numpy(),
                                  np.asarray(jimage.max_pool_3x3(jnp.asarray(s))))
    centers = np.random.default_rng(0).integers(-5, 260, (17, 2)).astype(np.int32)
    pj = jimage.gather_patches(jnp.asarray(img[0]), jnp.asarray(centers), 7)
    pt = timage.gather_patches(torch.tensor(img[0]), torch.tensor(centers), 7)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


def test_level0_fast_nms_topk_exact(images):
    """Integer level 0: corners, scores, NMS and the grid top-K match exactly."""
    img = images.astype(np.float32)
    cj, sj = jfast.fast_corners(jnp.asarray(img), float(FAST_TH))
    ct, st = tfast.fast_corners(torch.tensor(img), float(FAST_TH))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    score = np.where(np.asarray(cj), np.asarray(sj), -np.inf).astype(np.float32)
    nms = score >= np.asarray(jimage.max_pool_3x3(jnp.asarray(score)))
    valid = nms & np.asarray(jfast.border_mask(H, W, 19))[None] & np.isfinite(score)
    quota = int(jfast.level_quota(N_FEATS, N_LEVELS, 1.2)[0])
    ref = jfast.select_topk_grid(jnp.asarray(score), jnp.asarray(valid), quota)
    got = tfast.select_topk_grid(torch.tensor(score), torch.tensor(valid), quota)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tfast.level_quota(400, 8, 1.2), jfast.level_quota(400, 8, 1.2))


@pytest.mark.parametrize("pattern", [0, 1])
def test_agast_patterns_exact(images, pattern):
    """The AGAST 5/8 and 7/12 ring variants (use_agast) on integer images."""
    img = images.astype(np.float32)
    cj, sj = jfast.fast_corners(jnp.asarray(img), float(FAST_TH), pattern=pattern)
    ct, st = tfast.fast_corners(torch.tensor(img), float(FAST_TH), pattern=pattern)
    assert ct.any()
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("cell,k_per_cell", [(None, None), (16, 1), (8, 3)])
def test_topk_grid_ties_exact(cell, k_per_cell):
    """Scores with many exact ties: both sides break them to the lower index."""
    rng = np.random.default_rng(5)
    score = rng.integers(0, 6, (2, 64, 96)).astype(np.float32) * 8.0
    valid = rng.uniform(size=score.shape) < 0.7
    ref = jfast.select_topk_grid(jnp.asarray(score), jnp.asarray(valid), 40, cell, k_per_cell)
    got = tfast.select_topk_grid(torch.tensor(score), torch.tensor(valid), 40, cell, k_per_cell)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_orb_and_ic_angles_on_identical_keypoints(images):
    img = images[0].astype(np.float32)
    blurred = np.asarray(jimage.box_filter(jnp.asarray(img)[None], 5)[0])
    centers = np.random.default_rng(2).integers(19, 230, (60, 2)).astype(np.int32)
    centers[:, 1] = np.clip(centers[:, 1], 19, H - 20)
    patches, r0, c0 = jbrief.gather_sample_patches(jnp.asarray(blurred), jnp.asarray(centers))
    ang_j = np.asarray(jbrief.ic_angles_from_patches(patches, jnp.asarray(centers), r0, c0))
    wx, wy, _ = tbrief._ic_angle_weights()
    tp, tr0, tc0 = tbrief.gather_sample_patches(torch.tensor(blurred), torch.tensor(centers))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(patches))
    ang_t = tbrief.ic_angles_from_patches(tp, torch.tensor(centers), tr0, tc0,
                                          torch.tensor(wx), torch.tensor(wy))
    np.testing.assert_allclose(ang_t.numpy(), ang_j, rtol=0, atol=1e-5)
    # same angles in -> bit-identical descriptors out
    desc_j = jbrief.compute_orb_from_patches(patches, jnp.asarray(centers), r0, c0, jnp.asarray(ang_j), 32)
    desc_t = tbrief.compute_orb_from_patches(tp, torch.tensor(centers), tr0, tc0, torch.tensor(ang_j),
                                             pattern=torch.tensor(tbrief.brief_pattern(512)))
    np.testing.assert_array_equal(desc_t.numpy(), np.asarray(desc_j))


def test_extract_features_parity(images, rigs):
    jrig, trig = rigs
    js = JSettings(n_features=N_FEATS, n_levels=N_LEVELS, scale_factor=1.2, fast_th=FAST_TH)
    ts = ExtractorSettings(n_features=N_FEATS, n_levels=N_LEVELS, scale_factor=1.2, fast_th=FAST_TH)
    fj = extract_features_jit(jnp.asarray(images), jrig.cams, js)
    fj = {k: np.asarray(getattr(fj, k)) for k in ("uv", "octave", "angle", "rays", "desc", "valid", "response")}
    tables = ExtractorTables(ts, H, W, device="cpu")
    ft = extract_features(torch.tensor(images), trig.cams, ts, tables)
    assert ft.uv.shape == (C, N_FEATS, 2) and ft.desc.shape == (C, N_FEATS, 32)
    assert ft.desc.dtype == torch.uint8 and ft.octave.dtype == torch.int32
    ft = {k: getattr(ft, k).numpy() for k in fj}
    n_kp, n_shared, bits, bits_equal = 0, 0, 0, 0
    for c in range(C):
        key = lambda f, i: (int(f["octave"][c, i]), float(f["uv"][c, i, 0]), float(f["uv"][c, i, 1]))
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
        # level 0 is exact: the same keypoints in the same slots
        lvl0 = fj["octave"][c] == 0
        np.testing.assert_array_equal(ft["uv"][c][lvl0], fj["uv"][c][lvl0])
        np.testing.assert_array_equal(ft["valid"][c][lvl0], fj["valid"][c][lvl0])
    assert n_kp > 0.8 * C * N_FEATS
    assert n_shared >= 0.99 * n_kp, f"keypoint agreement {n_shared}/{n_kp}"
    assert bits_equal >= 0.99 * bits, f"descriptor bit agreement {bits_equal}/{bits}"
