"""Port parity: the dBRIEF/mdBRIEF descriptor path (`ops/brief` and the
`use_mdbrief` branch of `slam/features`) against the JAX package, on the
CPU at a small shape (2 cameras of 128x96, the synthetic fisheye rig).

Tolerances:
- `undistort_keypoints`: 1e-3 px absolute (float32; the worst keypoint's
  difference is printed);
- `_distorted_offsets`: >= 99.5 % of the integer offsets equal, the rest
  within 1 px (the mean over the pattern is summed in another order, and
  an offset near .5 may round the other way);
- `compute_dbrief_from_patches` / `compute_dbrief`, masks off and on, on
  JAX's patches and JAX's integer offsets: exact;
- `extract_features` with use_mdbrief (3 levels): level-0 keypoints exact,
  descriptor and stability-mask bits >= 99 % equal on shared keypoints,
  the learned masks not all 0xFF, and all 0xFF without learn_masks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.io.synthetic import make_synthetic_rig
from multicol_slam_tpu.ops import brief as jbrief
from multicol_slam_tpu.ops import image as jimage
from multicol_slam_tpu.slam.features import extract_features_jit
from multicol_slam_tpu.utils.config import ExtractorSettings as JSettings
from multicol_slam_tpu_torch import convert
from multicol_slam_tpu_torch.ops import brief as tbrief
from multicol_slam_tpu_torch.slam.features import ExtractorTables, extract_features
from multicol_slam_tpu_torch.utils.config import ExtractorSettings

C, H, W = 2, 96, 128
N_FEATS, N_LEVELS, FAST_TH = 96, 3, 12
CAM_FIELDS = ("pol", "invpol", "cde", "pp", "wh")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tier-1 run puts six test processes on the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rigs():
    jrig = make_synthetic_rig(n_cams=C, w=W, h=H)
    trig = convert.rig_from_numpy(*(np.asarray(getattr(jrig.cams, k)) for k in CAM_FIELDS),
                                  np.asarray(jrig.Mc_cayley), device="cpu")
    return jrig, trig


@pytest.fixture(scope="module")
def images():
    """Blurred-noise frames: corners everywhere, and patches whose tests are
    not all ties."""
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 256, (C, H, W)).astype(np.float32)
    return np.asarray(jimage.box_filter(jnp.asarray(raw), 3)).round().astype(np.uint8)


@pytest.fixture(scope="module")
def keypoints():
    """Keypoints inside the mirror circle and 19 px off the border, random angles."""
    rng = np.random.default_rng(9)
    uv = np.stack([rng.integers(19, W - 19, (C, 80)), rng.integers(19, H - 19, (C, 80))], -1).astype(np.int32)
    ang = rng.uniform(-np.pi, np.pi, (C, 80)).astype(np.float32)
    return uv, ang


@pytest.fixture(scope="module")
def jax_mdbrief(images, rigs):
    """The JAX package's jitted extraction with learn_masks=1 (its descriptors
    are those of learn_masks=0: the masks come on top)."""
    js = JSettings(n_features=N_FEATS, n_levels=N_LEVELS, scale_factor=1.2, fast_th=FAST_TH, use_mdbrief=1,
                   learn_masks=1)
    f = extract_features_jit(jnp.asarray(images), rigs[0].cams, js)
    return {k: np.asarray(getattr(f, k)) for k in ("uv", "octave", "angle", "rays", "desc", "dmask", "valid")}


def test_mask_rotation_is_the_reference_constant():
    assert np.float32(tbrief.MASK_ROTATION) == np.asarray(jnp.deg2rad(20.0))


def test_undistort_keypoints(rigs, keypoints):
    jrig, trig = rigs
    uv = keypoints[0].astype(np.float32) * np.float32(1.2)
    worst = 0.0
    for c in range(C):
        a0 = jrig.cams.pol[c, 0]
        ref = np.asarray(jbrief.undistort_keypoints(jrig.cams.pol[c], jrig.cams.cde[c], jrig.cams.pp[c], a0,
                                                    jnp.asarray(uv[c])))
        got = tbrief.undistort_keypoints(trig.cams.pol[c], trig.cams.cde[c], trig.cams.pp[c], trig.cams.pol[c, 0],
                                         torch.tensor(uv[c])).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
        worst = max(worst, float(np.abs(got - ref).max()))
    # batched over the cameras, as the extractor calls it
    batched = tbrief.undistort_keypoints(trig.cams.pol, trig.cams.cde, trig.cams.pp, trig.cams.pol[:, 0],
                                         torch.tensor(uv))
    for c in range(C):
        one = tbrief.undistort_keypoints(trig.cams.pol[c], trig.cams.cde[c], trig.cams.pp[c], trig.cams.pol[c, 0],
                                         torch.tensor(uv[c]))
        torch.testing.assert_close(batched[c], one, rtol=0, atol=0)
    print(f"undistort_keypoints: worst keypoint {worst:.3e} px from the reference")


def _offsets_both(rigs, uv, ang):
    jrig, trig = rigs
    pat = tbrief.brief_pattern(512)
    ref, got = [], []
    for c in range(C):
        a0 = jrig.cams.pol[c, 0]
        und = jbrief.undistort_keypoints(jrig.cams.pol[c], jrig.cams.cde[c], jrig.cams.pp[c], a0,
                                         jnp.asarray(uv[c].astype(np.float32)))
        ref.append(np.asarray(jbrief._distorted_offsets(jnp.asarray(pat), und, jnp.asarray(ang[c]),
                                                        jrig.cams.invpol[c], jrig.cams.cde[c], jrig.cams.pp[c], a0)))
    und_t = torch.tensor(np.stack([np.asarray(jbrief.undistort_keypoints(
        jrig.cams.pol[c], jrig.cams.cde[c], jrig.cams.pp[c], jrig.cams.pol[c, 0],
        jnp.asarray(uv[c].astype(np.float32)))) for c in range(C)]))
    got = tbrief._distorted_offsets(torch.tensor(pat), und_t, torch.tensor(ang), trig.cams.invpol, trig.cams.cde,
                                    trig.cams.pp, trig.cams.pol[:, 0]).numpy()
    return np.stack(ref), got


def test_distorted_offsets(rigs, keypoints):
    ref, got = _offsets_both(rigs, *keypoints)
    assert got.shape == ref.shape == (C, 80, 512, 2) and got.dtype == np.int32
    diff = np.abs(got - ref)
    equal = float((diff == 0).mean())
    print(f"_distorted_offsets: {equal * 100:.3f} % equal, worst {diff.max()} px")
    assert equal >= 0.995, equal
    assert diff.max() <= 1


@pytest.mark.parametrize("learn_masks", [False, True], ids=["dbrief", "mdbrief"])
def test_compute_dbrief_exact_on_shared_offsets(rigs, images, keypoints, monkeypatch, learn_masks):
    """The sampler, the tests, the packer and the mask logic: exact when the
    port is given JAX's integer offsets (its `_distorted_offsets` replaced
    by the reference's, for the 0 and +-20 degree patterns alike)."""
    jrig, trig = rigs
    uv, ang = keypoints
    pat = tbrief.brief_pattern(512)

    def jax_offsets(pattern, undist_kp, angles, invpol, cde, pp, a0):
        out = [jbrief._distorted_offsets(jnp.asarray(pattern.numpy()), jnp.asarray(undist_kp[c].numpy()),
                                         jnp.asarray(angles[c].numpy()), jnp.asarray(invpol[c].numpy()),
                                         jnp.asarray(cde[c].numpy()), jnp.asarray(pp[c].numpy()),
                                         jnp.asarray(a0[c].numpy())) for c in range(C)]
        return torch.tensor(np.stack([np.asarray(o) for o in out]))
    monkeypatch.setattr(tbrief, "_distorted_offsets", jax_offsets)
    und = np.stack([np.asarray(jbrief.undistort_keypoints(jrig.cams.pol[c], jrig.cams.cde[c], jrig.cams.pp[c],
                                                          jrig.cams.pol[c, 0], jnp.asarray(uv[c].astype(np.float32))))
                    for c in range(C)])
    img = images.astype(np.float32)
    got = tbrief.compute_dbrief(torch.tensor(img), torch.tensor(uv), torch.tensor(und), torch.tensor(ang),
                                trig.cams.invpol, trig.cams.cde, trig.cams.pp, trig.cams.pol[:, 0],
                                learn_masks=learn_masks, pattern=torch.tensor(pat))
    patches, r0, c0 = tbrief.gather_sample_patches(torch.tensor(img), torch.tensor(uv))
    got_p = tbrief.compute_dbrief_from_patches(patches, torch.tensor(uv), r0, c0, torch.tensor(und),
                                               torch.tensor(ang), trig.cams.invpol, trig.cams.cde, trig.cams.pp,
                                               trig.cams.pol[:, 0], learn_masks=learn_masks,
                                               pattern=torch.tensor(pat))
    for c in range(C):
        args = (jnp.asarray(uv[c]), jnp.asarray(und[c]), jnp.asarray(ang[c]), jrig.cams.invpol[c],
                jrig.cams.cde[c], jrig.cams.pp[c], jrig.cams.pol[c, 0])
        ref = jbrief.compute_dbrief(jnp.asarray(img[c]), *args, desc_bytes=32, learn_masks=learn_masks)
        jp, jr0, jc0 = jbrief.gather_sample_patches(jnp.asarray(img[c]), jnp.asarray(uv[c]))
        ref_p = jbrief.compute_dbrief_from_patches(jp, args[0], jr0, jc0, *args[1:], 32, learn_masks)
        for g, r in ((got, ref), (got_p, ref_p)):
            np.testing.assert_array_equal(g[0][c].numpy(), np.asarray(r[0]))
            np.testing.assert_array_equal(g[1][c].numpy(), np.asarray(r[1]))
    if learn_masks:
        assert (got[1].numpy() < 255).any()
    else:
        assert (got[1].numpy() == 255).all()


@pytest.mark.parametrize("learn_masks", [0, 1], ids=["masks0", "masks1"])
def test_extract_features_mdbrief(images, rigs, jax_mdbrief, learn_masks):
    ts = ExtractorSettings(n_features=N_FEATS, n_levels=N_LEVELS, scale_factor=1.2, fast_th=FAST_TH, use_mdbrief=1,
                           learn_masks=learn_masks)
    ft = extract_features(torch.tensor(images), rigs[1].cams, ts, ExtractorTables(ts, H, W, device="cpu"))
    assert ft.desc.shape == ft.dmask.shape == (C, N_FEATS, 32) and ft.dmask.dtype == torch.uint8
    fj = jax_mdbrief
    ft = {k: getattr(ft, k).numpy() for k in fj}
    n_kp = n_shared = 0
    bits = {"desc": [0, 0], "dmask": [0, 0]}
    for c in range(C):
        key = lambda f, i: (int(f["octave"][c, i]), float(f["uv"][c, i, 0]), float(f["uv"][c, i, 1]))  # noqa: E731
        kj = {key(fj, i): i for i in np.nonzero(fj["valid"][c])[0]}
        kt = {key(ft, i): i for i in np.nonzero(ft["valid"][c])[0]}
        shared = kj.keys() & kt.keys()
        n_kp += max(len(kj), len(kt))
        n_shared += len(shared)
        for k in shared:
            i, j = kj[k], kt[k]
            for name in ("desc", "dmask") if learn_masks else ("desc",):
                x = np.unpackbits(fj[name][c, i] ^ ft[name][c, j])
                bits[name][0] += x.size - int(x.sum())
                bits[name][1] += x.size
        lvl0 = fj["octave"][c] == 0
        np.testing.assert_array_equal(ft["uv"][c][lvl0], fj["uv"][c][lvl0])
        np.testing.assert_array_equal(ft["valid"][c][lvl0], fj["valid"][c][lvl0])
    assert n_kp > 0.8 * C * N_FEATS and n_shared >= 0.99 * n_kp, (n_shared, n_kp)
    for name, (eq, total) in bits.items():
        print(f"{name}: {eq}/{total} bits equal")
        assert total == 0 or eq >= 0.99 * total, (name, eq, total)
    valid = ft["valid"]
    if learn_masks:
        assert bits["dmask"][1] > 0 and (ft["dmask"][valid] < 255).any()
    else:
        assert (ft["dmask"] == 255).all()


def test_mdbrief_squares_image():
    """The JAX package's own mdBRIEF case (tests/test_features.py:170): one
    mild-fisheye camera on isolated squares at 128x96, 3 levels. The masks
    are not all 0xFF on valid keypoints; the level-0 keypoints are the
    reference's, and the descriptor and mask bits of the shared keypoints
    agree >= 99 % (the IC angle of a flat square is a ratio of moments near
    0, summed in another order than XLA's, so a pattern may turn a rounding
    step further)."""
    from multicol_slam_tpu.models.camera import OmniCamera as JCamera

    pol = [[-120.0, 0.0, 0.002, 0.0, 0.0]]
    invpol = [[115.0, 60.0, 5.0] + [0.0] * 9]
    jc = JCamera.from_params(pol, invpol, [[1.0, 0.0, 0.0]], [[64.0, 48.0]], [[128, 96]])
    tc = convert.rig_from_numpy(*(np.asarray(getattr(jc, k)) for k in CAM_FIELDS), np.zeros((1, 6)),
                                device="cpu").cams
    img = np.full((96, 128), 40.0, np.float32)
    for y0 in range(8, 96 - 14, 24):
        for x0 in range(8, 128 - 14, 24):
            img[y0:y0 + 10, x0:x0 + 10] = 210.0
    js = JSettings(n_features=64, n_levels=3, fast_th=15, use_mdbrief=1, learn_masks=1)
    ts = ExtractorSettings(n_features=64, n_levels=3, fast_th=15, use_mdbrief=1, learn_masks=1)
    fj = extract_features_jit(jnp.asarray(img[None]), jc, js)
    ft = extract_features(torch.tensor(img[None]), tc, ts, ExtractorTables(ts, 96, 128, device="cpu"))
    v = np.asarray(fj.valid[0])
    lvl0 = v & (np.asarray(fj.octave[0]) == 0)
    assert lvl0.sum() > 0 and ft.dmask[0].numpy()[ft.valid[0].numpy()].min() < 255
    np.testing.assert_array_equal(ft.uv[0].numpy()[lvl0], np.asarray(fj.uv[0])[lvl0])
    np.testing.assert_array_equal(ft.valid[0].numpy()[lvl0], v[lvl0])
    for name in ("desc", "dmask"):
        x = np.unpackbits(getattr(ft, name)[0].numpy()[lvl0] ^ np.asarray(getattr(fj, name)[0])[lvl0])
        print(f"squares {name}: {x.size - int(x.sum())}/{x.size} bits equal")
        assert x.sum() <= 0.01 * x.size, (name, int(x.sum()), x.size)
