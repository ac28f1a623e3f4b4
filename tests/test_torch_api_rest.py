"""The rest of the JAX package's public functions in the port, each against
the JAX function on the same numpy inputs (the functions that the JAX
package's own tests call: tests/test_camera.py, test_features.py,
test_matching.py, test_native.py; the map store's per-point queries; and
the reference's calling conventions: `FrameFeatures.n_cams` / `.k`,
`TrackStageOut.fetch()`, `initializer.DEBUG_INIT`, `desc_bytes=` on the
BRIEF functions with the pattern made from it, `ic_angles_from_patches`
without its weights, `sample_indices(..., weights=)`).

Tolerances: integer and boolean outputs, descriptors and the map store's
arrays exactly; pixels 1e-3 px (float32 projections through polynomials of
~300 px; measured 6.1e-5); unit rays and camera-frame points 1e-5
(measured 9.5e-7); centres 1e-5 / 1e-6 (measured 0); IC angles 1e-4 rad
(float32 moment sums in another order; measured 1.3e-5); dBRIEF / mdBRIEF
descriptor and mask bits >= 99 % equal to the JAX package's (ROADMAP Queue
3, Slice 6: an offset near .5 may round the other way), and exactly equal
to the port's call with the extractor's explicit pattern.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from multicol_slam_tpu import native as jnative
from multicol_slam_tpu.io.synthetic import make_world
from multicol_slam_tpu.models import camera as jcam
from multicol_slam_tpu.models import rig as jrig
from multicol_slam_tpu.ops import brief as jbrief
from multicol_slam_tpu.ops import image as jimage
from multicol_slam_tpu.ops import matching as jmatch
from multicol_slam_tpu.ops import ransac as jransac
from multicol_slam_tpu.slam import initializer as jinit
from multicol_slam_tpu.slam import map_store as jms
from multicol_slam_tpu.slam import tracking_kernels as jtk
from multicol_slam_tpu.utils.geometry import cayley_to_hom as jcayley_to_hom
from multicol_slam_tpu_torch import convert, native
from multicol_slam_tpu_torch.models import camera as tcam
from multicol_slam_tpu_torch.models import rig as trig
from multicol_slam_tpu_torch.ops import brief as tbrief
from multicol_slam_tpu_torch.ops import image as timage
from multicol_slam_tpu_torch.ops import matching as tmatch
from multicol_slam_tpu_torch.ops import ransac as transac
from multicol_slam_tpu_torch.slam import initializer as tinit
from multicol_slam_tpu_torch.slam import map_store as tms
from multicol_slam_tpu_torch.slam import tracking_kernels as ttk
from multicol_slam_tpu_torch.slam.features import FIELDS
from multicol_slam_tpu_torch.utils.geometry import cayley_to_hom
from tests.test_torch_map_store import CFG, _features

# 754x480 Lafida-like cameras (chip_smoke.py's polynomials), three of them
POL = [-209.2, 0.0, 0.0021, -4.2e-06, 1.77e-08]
INVPOL = [293.7, 150.0, -10.4, 28.2, 7.1, 0.06, 10.4, 0.17, -5.9, 1.18, 3.1, 0.81]
CAM_ARGS = ([POL] * 3, [INVPOL] * 3, [[1.0, 0.0, 0.0], [0.999, 0.001, -0.002], [1.001, -0.001, 0.001]],
            [[377.0, 240.0], [375.5, 241.2], [378.1, 239.4]], [[754, 480]] * 3)
MC = np.array([[0.0] * 6, [0.05, -0.02, 0.3, 0.2, 0.0, 0.0], [-0.04, 0.03, -0.2, 0.0, 0.2, 0.05]], np.float32)


@pytest.fixture(scope="module")
def cams():
    return jcam.OmniCamera.from_params(*CAM_ARGS), tcam.OmniCamera.from_params(*CAM_ARGS, device="cpu")


@pytest.fixture(scope="module")
def rigs(cams):
    jc, tc = cams
    return jrig.MultiCamRig.from_cayley(jc, jnp.asarray(MC)), trig.MultiCamRig.from_cayley(tc, torch.tensor(MC))


def _near(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=0, atol=atol)


def _rays(rng, shape):
    r = rng.normal(size=shape + (3,)) * np.array([1.0, 1.0, 0.3]) + np.array([0.0, 0.0, 1.0])
    return (r * rng.uniform(1, 8, shape + (1,))).astype(np.float32)


# --- models/camera -----------------------------------------------------------

def test_rig_world_to_img_and_back(cams):
    jc, tc = cams
    rng = np.random.default_rng(1)
    X = _rays(rng, (3, 4, 17))
    uv_j = np.asarray(jcam.rig_world_to_img(jc, jnp.asarray(X)))
    uv_t = tcam.rig_world_to_img(tc, torch.tensor(X)).numpy()
    _near(uv_t, uv_j, 1e-3)
    uv = rng.uniform(100, 380, (3, 17, 2)).astype(np.float32)
    _near(tcam.rig_img_to_world(tc, torch.tensor(uv)).numpy(), jcam.rig_img_to_world(jc, jnp.asarray(uv)), 1e-5)
    assert tc.n_cams == jc.n_cams == 3


@pytest.mark.parametrize("cam_idx", [0, 2])
def test_mirror_mask_raster(cams, cam_idx):
    jc, tc = cams
    got, want = tcam.mirror_mask_raster(tc, cam_idx, 8), jcam.mirror_mask_raster(jc, cam_idx, 8)
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# --- models/rig --------------------------------------------------------------

def test_with_extrinsics(rigs):
    jr, tr = rigs
    mc2 = MC + np.float32(0.01)
    j2, t2 = jr.with_extrinsics(jnp.asarray(mc2)), tr.with_extrinsics(torch.tensor(mc2))
    assert t2.cams is tr.cams and t2 is not tr
    _near(t2.Mc.numpy(), j2.Mc, 1e-6)
    np.testing.assert_array_equal(t2.Mc_cayley.numpy(), mc2)


def test_world_to_cam_frame_and_project_mcs(rigs):
    jr, tr = rigs
    rng = np.random.default_rng(2)
    pose = rng.normal(0, 0.05, (11, 6)).astype(np.float32)
    cam = rng.integers(0, 3, 11)
    Xc = _rays(rng, (11,))
    # world points on each camera's rays, in front of it
    MtMc = np.asarray(jnp.einsum("nij,njk->nik", jcayley_to_hom(jnp.asarray(pose)), jr.Mc[cam]))
    X = (np.einsum("nij,nj->ni", MtMc[:, :3, :3], Xc) + MtMc[:, :3, 3]).astype(np.float32)
    Mt_t = cayley_to_hom(torch.tensor(pose))
    got = trig.world_to_cam_frame(Mt_t, tr.Mc[torch.tensor(cam)], torch.tensor(X))
    _near(got.numpy(), jrig.world_to_cam_frame(jcayley_to_hom(jnp.asarray(pose)), jr.Mc[cam], jnp.asarray(X)), 1e-5)
    _near(trig.world_to_cam_frame(Mt_t[0], tr.Mc[1], torch.tensor(X)).numpy(),
          jrig.world_to_cam_frame(jcayley_to_hom(jnp.asarray(pose[0])), jr.Mc[1], jnp.asarray(X)), 1e-5)
    uv_t, z_t = trig.project_mcs(tr, torch.tensor(pose), torch.tensor(cam), torch.tensor(X))
    uv_j, z_j = jrig.project_mcs(jr, jnp.asarray(pose), jnp.asarray(cam), jnp.asarray(X))
    _near(uv_t.numpy(), uv_j, 1e-3)
    _near(z_t.numpy(), z_j, 1e-5)
    assert (z_t > 0).all()
    jc, tc = jr.cams, tr.cams
    args_t = (tc.invpol[cam], tc.cde[cam], tc.pp[cam], torch.tensor(pose), torch.tensor(MC[cam]), torch.tensor(X))
    args_j = (jc.invpol[cam], jc.cde[cam], jc.pp[cam], jnp.asarray(pose), jnp.asarray(MC[cam]), jnp.asarray(X))
    uv_t2, z_t2 = trig.project_mcs_params(*args_t)
    uv_j2, z_j2 = jrig.project_mcs_params(*args_j)
    _near(uv_t2.numpy(), uv_j2, 1e-3)
    _near(z_t2.numpy(), z_j2, 1e-5)
    _near(uv_t2.numpy(), uv_t.numpy(), 1e-3)


def test_camera_and_body_centers(rigs):
    jr, tr = rigs
    pose = np.random.default_rng(3).normal(0, 0.2, (5, 6)).astype(np.float32)
    Mt_j, Mt_t = jcayley_to_hom(jnp.asarray(pose)), cayley_to_hom(torch.tensor(pose))
    c_t = trig.camera_centers(tr, Mt_t)
    assert c_t.shape == (5, 3, 3)
    _near(c_t.numpy(), jrig.camera_centers(jr, Mt_j), 1e-5)
    _near(trig.camera_centers(tr, torch.eye(4)).numpy(), tr.Mc[:, :3, 3].numpy(), 1e-6)
    _near(trig.body_center(Mt_t).numpy(), jrig.body_center(Mt_j), 1e-6)


# --- ops/brief, ops/image ----------------------------------------------------

def test_ic_angles(cams):
    rng = np.random.default_rng(3)
    imgs = rng.uniform(0, 255, (2, 96, 128)).astype(np.float32)
    # inside the 19 px detection border, and a few on the image's edge
    centers = np.stack([rng.integers(20, 108, (2, 17)), rng.integers(20, 76, (2, 17))], axis=-1).astype(np.int32)
    edge = np.array([[0, 0], [127, 95], [3, 50], [120, 2]], np.int32)
    for c in range(2):
        for cs in (centers[c], edge):
            _near(tbrief.ic_angles(torch.tensor(imgs[c]), torch.tensor(cs)).numpy(),
                  jbrief.ic_angles(jnp.asarray(imgs[c]), jnp.asarray(cs)), 1e-4)
    dense = tbrief.ic_angles_dense(torch.tensor(imgs), torch.tensor(centers)).numpy()
    _near(dense, jbrief.ic_angles_dense(jnp.asarray(imgs), jnp.asarray(centers)), 1e-4)
    assert dense.shape == (2, 17)


def test_compute_orb():
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 255, (128, 128)).astype(np.float32)
    blurred = np.asarray(jimage.box_filter(jnp.asarray(img)[None], 5)[0])
    centers = rng.integers(20, 100, (32, 2)).astype(np.int32)
    ang = np.asarray(jbrief.ic_angles(jnp.asarray(img), jnp.asarray(centers)))
    for desc_bytes in (16, 32):
        want = np.asarray(jbrief.compute_orb(jnp.asarray(blurred), jnp.asarray(centers), jnp.asarray(ang), desc_bytes))
        got = tbrief.compute_orb(torch.tensor(blurred), torch.tensor(centers), torch.tensor(ang), desc_bytes)
        assert got.dtype == torch.uint8 and got.shape == (32, desc_bytes)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_levels, scale", [(8, 1.2), (4, 2.0), (1, 1.2)])
def test_scale_factors(n_levels, scale):
    got, want = timage.scale_factors(n_levels, scale), jimage.scale_factors(n_levels, scale)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# --- ops/matching ------------------------------------------------------------

@pytest.mark.parametrize("ratio", [None, 0.9, 0.8])
def test_masked_best_match(ratio):
    rng = np.random.default_rng(5)
    dist = rng.integers(0, 120, (40, 60)).astype(np.float32)      # integer distances: ties
    mask = rng.uniform(size=(40, 60)) < 0.3
    mask[3] = False                                                # a row with no candidate
    got = tmatch.masked_best_match(torch.tensor(dist), torch.tensor(mask), 64.0, ratio)
    want = jmatch.masked_best_match(jnp.asarray(dist), jnp.asarray(mask), 64.0, ratio)
    for a, b in zip(got, want):
        assert a.dtype == {np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32,
                           np.dtype(bool): torch.bool}[np.asarray(b).dtype]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    idx, d, ok = tmatch.masked_best_match(torch.tensor([[10.0, 50.0, 60.0], [10.0, 11.0, 60.0], [99.0, 98.0, 97.0]]),
                                          torch.ones(3, 3, dtype=torch.bool), 64.0, 0.9)
    assert idx[:2].tolist() == [0, 0] and ok.tolist() == [True, False, False]     # tests/test_matching.py:61


def test_resolve_duplicate_targets():
    rng = np.random.default_rng(6)
    idx = rng.integers(0, 12, 50).astype(np.int32)
    dist = rng.integers(0, 30, 50).astype(np.float32)
    ok = rng.uniform(size=50) < 0.8
    got = tmatch.resolve_duplicate_targets(torch.tensor(idx), torch.tensor(dist), torch.tensor(ok), 12)
    want = jmatch.resolve_duplicate_targets(jnp.asarray(idx), jnp.asarray(dist), jnp.asarray(ok), 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    keep = tmatch.resolve_duplicate_targets(torch.tensor([0, 0, 1]), torch.tensor([5.0, 3.0, 1.0]),
                                            torch.ones(3, dtype=torch.bool), 2)
    assert keep.tolist() == [False, True, True]


@pytest.mark.parametrize("radius", ["scalar", "per_query", "levels"])
def test_window_mask(radius):
    rng = np.random.default_rng(7)
    uv_q = rng.uniform(0, 100, (30, 2)).astype(np.float32)
    uv_t = rng.uniform(0, 100, (45, 2)).astype(np.float32)
    oq, ot = rng.integers(0, 8, 30).astype(np.int32), rng.integers(0, 8, 45).astype(np.int32)
    r = 12.0 if radius != "per_query" else rng.uniform(5, 20, 30).astype(np.float32)
    kw = dict(level_tol=1) if radius == "levels" else {}
    got = tmatch.window_mask(torch.tensor(uv_q), torch.tensor(uv_t), torch.tensor(r) if np.ndim(r) else r,
                             torch.tensor(oq) if kw else None, torch.tensor(ot) if kw else None, **kw)
    want = jmatch.window_mask(jnp.asarray(uv_q), jnp.asarray(uv_t), jnp.asarray(r) if np.ndim(r) else r,
                              jnp.asarray(oq) if kw else None, jnp.asarray(ot) if kw else None, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < got.numel()


# --- slam/map_store, native --------------------------------------------------

def test_map_store_point_queries():
    js, ts = jms.MapStore(jms.MapConfig(**CFG)), tms.MapStore(tms.MapConfig(**CFG))
    rng = np.random.default_rng(8)
    F = CFG["n_cams"] * CFG["feats_per_cam"]
    for k in range(4):
        jf, tf = _features(rng)
        pose = rng.normal(0, 0.3, 6).astype(np.float32)
        js.add_keyframe(pose, jf, 0.04 * k, k)
        ts.add_keyframe(pose, tf, 0.04 * k, k)
    for _ in range(12):
        X = rng.normal(0, 3, 3).astype(np.float32)
        k0, f0 = int(rng.integers(0, 4)), int(rng.integers(0, F))
        args = (X, js.kf_desc[k0, f0], js.kf_dmask[k0, f0], k0, np.zeros(3, np.float32), 0.1, 25.0)
        p = js.add_point(*args)
        assert ts.add_point(*args) == p
        for k in rng.choice(4, int(rng.integers(2, 4)), replace=False):
            f = int(rng.integers(0, F))
            js.add_observation(int(k), f, p)
            ts.add_observation(int(k), f, p)
    ps = np.array([0, 3, 3, 7, 11])
    np.testing.assert_array_equal(ts.point_n_obs_many(ps), js.point_n_obs_many(ps))
    for p in range(12):
        for a, b in zip(ts.point_observers(p), js.point_observers(p)):
            np.testing.assert_array_equal(a, b)
        js.update_point_stats(p)
        ts.update_point_stats(p)
    for name in ("pt_desc", "pt_normal", "pt_min_dist", "pt_max_dist"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name), err_msg=name)


def test_native_count_observations():
    """tests/test_native.py:42's table: the C scan, its numpy version and the
    JAX package's equal."""
    rng = np.random.default_rng(31)
    kf_point = np.full((12, 60), -1, np.int32)
    fill = rng.random((12, 60)) < 0.6
    kf_point[fill] = rng.integers(0, 40, fill.sum())
    kf_valid = np.ones(12, bool)
    kf_valid[rng.integers(0, 12, 2)] = False
    assert native.available() and jnative.available()
    for ids in (np.arange(40, dtype=np.int32), rng.permutation(50).astype(np.int32)[:23], np.zeros(0, np.int32)):
        got = native.count_observations(kf_point, kf_valid, ids)
        np.testing.assert_array_equal(got, native.count_observations_plain(kf_point, kf_valid, ids))
        np.testing.assert_array_equal(got, jnative.count_observations(kf_point, kf_valid, ids))
        assert got.dtype == np.int32


# --- the reference's calling conventions ------------------------------------

@pytest.fixture(scope="module")
def line_world():
    """tests/test_torch_initializer.py's line world."""
    return make_world(n_points=500, n_frames=8, n_cams=2, n_feats=250, noise_px=0.2, trajectory="line", seed=1)


def _port_features(jf):
    return convert.frame_features_from_numpy(**{k: np.asarray(getattr(jf, k)) for k in FIELDS}, device="cpu")


def test_frame_features_n_cams_and_k(line_world):
    jf = line_world.frame_features(0)
    tf = _port_features(jf)
    assert (tf.n_cams, tf.k) == (jf.n_cams, jf.k) == (2, 250)
    assert isinstance(tf.n_cams, int) and isinstance(tf.k, int)


def test_track_stage_out_fetch():
    """The same packed stage result: the same host tuple, types included."""
    rng = np.random.default_rng(5)
    ck = 2 * 7
    packed = np.concatenate([rng.normal(size=6), [9.0, 6.0], rng.integers(-1, 30, ck),
                             rng.random(ck) > 0.5]).astype(np.float32)
    z = np.zeros(1, np.float32)
    want = jtk.TrackStageOut(*(jnp.asarray(z),) * 5, packed=jnp.asarray(packed)).fetch()
    got = ttk.TrackStageOut(*(torch.tensor(z),) * 5, packed=torch.tensor(packed)).fetch()
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert type(g) is type(w)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w
    assert got[1:3] == (9, 6) and got[3].dtype == np.int32 and got[4].dtype == bool


@pytest.mark.parametrize("case", ["same_frame", "few_matches"])
def test_debug_init_prints_the_same_rejection(line_world, monkeypatch, capsys, case):
    """DEBUG_INIT on: both packages print the same gate's rejection (a
    frame against itself fits no essential matrix: zero baseline; a frame
    with most features dropped has too few matches). Off (the default):
    nothing is printed."""
    j1 = line_world.frame_features(0)
    j2 = j1
    if case == "few_matches":
        valid = np.asarray(j1.valid).copy()
        valid[:, 40:] = False
        j2 = type(j1)(**{k: (valid if k == "valid" else np.asarray(getattr(j1, k))) for k in FIELDS})
    trig_ = convert.rig_from_numpy(*(np.asarray(getattr(line_world.rig.cams, k))
                                     for k in ("pol", "invpol", "cde", "pp", "wh")),
                                   np.asarray(line_world.rig.Mc_cayley), device="cpu")
    sampler = lambda c, n: torch.tensor(np.asarray(  # noqa: E731
        jransac.sample_indices(jax.random.fold_in(jax.random.PRNGKey(0), c), 256, 8, n)))
    assert not tinit.DEBUG_INIT and not jinit.DEBUG_INIT
    assert tinit.bootstrap(trig_, _port_features(j1), _port_features(j2), sampler=sampler)[0] is None
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(jinit, "DEBUG_INIT", True)
    monkeypatch.setattr(tinit, "DEBUG_INIT", True)
    rj, nj = jinit.bootstrap(line_world.rig, j1, j2, key=jax.random.PRNGKey(0))
    want = capsys.readouterr().out
    rt, nt = tinit.bootstrap(trig_, _port_features(j1), _port_features(j2), sampler=sampler)
    got = capsys.readouterr().out
    assert rj is None and rt is None and nt == nj
    assert got == want and got.startswith("[bootstrap] reject: ")
    assert ("matches" if case == "few_matches" else "essential inliers") in got


def test_brief_desc_bytes_and_default_tables(cams):
    """compute_orb_from_patches, compute_dbrief and
    compute_dbrief_from_patches called the reference's way (desc_bytes=,
    no pattern), and ic_angles_from_patches without wx, wy."""
    jc, tc = cams
    rng = np.random.default_rng(6)
    img = np.asarray(jimage.box_filter(jnp.asarray(rng.uniform(0, 255, (1, 480, 754)).astype(np.float32)), 5)[0])
    centers = np.stack([rng.integers(20, 734, 40), rng.integers(20, 460, 40)], -1).astype(np.int32)
    jp, jr0, jc0 = jbrief.gather_sample_patches(jnp.asarray(img), jnp.asarray(centers))
    tp, tr0, tc0 = tbrief.gather_sample_patches(torch.tensor(img), torch.tensor(centers))
    ang = np.asarray(jbrief.ic_angles_from_patches(jp, jnp.asarray(centers), jr0, jc0))
    _near(tbrief.ic_angles_from_patches(tp, torch.tensor(centers), tr0, tc0).numpy(), ang, 1e-4)
    ang_t = torch.tensor(ang)
    for desc_bytes in (16, 32):
        want = np.asarray(jbrief.compute_orb_from_patches(jp, jnp.asarray(centers), jr0, jc0, jnp.asarray(ang),
                                                          desc_bytes=desc_bytes))
        got = tbrief.compute_orb_from_patches(tp, torch.tensor(centers), tr0, tc0, ang_t, desc_bytes=desc_bytes)
        assert got.shape == (40, desc_bytes)
        np.testing.assert_array_equal(got.numpy(), want)
    c = 1
    und = np.asarray(jbrief.undistort_keypoints(jc.pol[c], jc.cde[c], jc.pp[c], jc.pol[c, 0],
                                                jnp.asarray(centers.astype(np.float32))))
    jargs = (jnp.asarray(und), jnp.asarray(ang), jc.invpol[c], jc.cde[c], jc.pp[c], jc.pol[c, 0])
    targs = (torch.tensor(und), ang_t, tc.invpol[c], tc.cde[c], tc.pp[c], tc.pol[c, 0])
    for desc_bytes in (16, 32):
        pattern = torch.tensor(tbrief.brief_pattern(16 * desc_bytes))
        want = jbrief.compute_dbrief(jnp.asarray(img), jnp.asarray(centers), *jargs, desc_bytes=desc_bytes,
                                     learn_masks=True)
        want_p = jbrief.compute_dbrief_from_patches(jp, jnp.asarray(centers), jr0, jc0, *jargs, desc_bytes, True)
        got = tbrief.compute_dbrief(torch.tensor(img), torch.tensor(centers), *targs, desc_bytes=desc_bytes,
                                    learn_masks=True)
        got_p = tbrief.compute_dbrief_from_patches(tp, torch.tensor(centers), tr0, tc0, *targs, desc_bytes, True)
        explicit = tbrief.compute_dbrief_from_patches(tp, torch.tensor(centers), tr0, tc0, *targs, desc_bytes, True,
                                                      pattern=pattern)
        for g, w in ((got, want), (got_p, want_p)):
            for a, b, e in zip(g, w, explicit):
                assert a.shape == (40, desc_bytes) and a.dtype == torch.uint8
                np.testing.assert_array_equal(a.numpy(), e.numpy())
                agree = np.mean(np.unpackbits(a.numpy()) == np.unpackbits(np.asarray(b)))
                assert agree >= 0.99, agree


def test_sample_indices_weights():
    """weights=: m distinct indices a row, never one of weight 0, as the
    reference's choice without replacement draws them; sample_weighted is
    the same draw."""
    w = np.ones(30, np.float32)
    w[[0, 3, 7, 8, 20]] = 0.0
    w[10:15] = 4.0
    want = np.asarray(jransac.sample_indices(jax.random.PRNGKey(2), 200, 6, 30, weights=jnp.asarray(w / w.sum())))
    got = transac.sample_indices(200, 6, 30, torch.Generator().manual_seed(2), weights=torch.tensor(w)).numpy()
    for idx in (got, want):
        assert idx.shape == (200, 6)
        assert all(len(set(row)) == 6 for row in idx.tolist())
        assert (w[idx] > 0).all()
    # the heavy rows are drawn more often in both
    for idx in (got, want):
        assert np.isin(idx, np.arange(10, 15)).mean() > 0.25
    valid = torch.tensor(w > 0)
    np.testing.assert_array_equal(transac.sample_weighted(200, 6, valid, torch.Generator().manual_seed(3)).numpy(),
                                  transac.sample_indices(200, 6, 30, torch.Generator().manual_seed(3),
                                                         weights=valid).numpy())
