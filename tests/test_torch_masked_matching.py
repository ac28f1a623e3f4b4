"""Port parity of every matcher on the mdBRIEF masked Hamming distance
(`use_masks`, thresholds x0.5), against the JAX package on the CPU.

Inputs: oracle features of tests/test_slam_e2e.py's line world (2 cameras,
250 features a camera), each feature given its landmark's seeded stability
mask (`tests/torch_mdbrief_masks.py`); the keyframes sit at the world's
ground-truth poses. The same numpy arrays go to both packages; the port's
best-match calls take K1's plain version (CPU tensors).

Tolerances: integer and boolean outputs (match indices, keep flags, the
bootstrap's leading camera) exact; masked distances exact (half-integers
in float32); triangulated points within 5e-4 relative + 1e-4 absolute
(tests/test_torch_local_mapping.py's bound); the bootstrap's pose within
1e-3 and its feature sets within 1 % (tests/test_torch_initializer.py's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.io.synthetic import make_world
from multicol_slam_tpu.ops import matching as jmatching
from multicol_slam_tpu.ops import ransac as jransac
from multicol_slam_tpu.slam import initializer as jinit
from multicol_slam_tpu.slam import local_mapping as jlm
from multicol_slam_tpu.slam import loop_closing as jlc
from multicol_slam_tpu.slam.features import FrameFeatures as JF
from multicol_slam_tpu.slam.map_store import MapConfig as JMapConfig
from multicol_slam_tpu.slam.map_store import MapStore as JMapStore
from multicol_slam_tpu.slam.tracking_kernels import LocalPoints as JLP
from multicol_slam_tpu.slam.tracking_kernels import match_window_frames as jmatch_window
from multicol_slam_tpu_torch import convert
from multicol_slam_tpu_torch.ops import matching as tmatching
from multicol_slam_tpu_torch.ops.best_match import masked_best_match_cams_plain
from multicol_slam_tpu_torch.slam import initializer as tinit
from multicol_slam_tpu_torch.slam import local_mapping as tlm
from multicol_slam_tpu_torch.slam import loop_closing as tlc
from multicol_slam_tpu_torch.slam.features import FrameFeatures as TF
from multicol_slam_tpu_torch.slam.map_store import MapConfig, MapStore
from multicol_slam_tpu_torch.slam.map_store import cayley_to_hom_np, hom_to_cayley_np
from multicol_slam_tpu_torch.slam.tracking_kernels import LocalPoints as TLP
from multicol_slam_tpu_torch.slam.tracking_kernels import match_window_frames
from torch_mdbrief_masks import FIELDS, landmark_masks, masked_fields

N_FEATS, B = 250, 32
TH_LOW_MASKED = 1.0 * B
MAP = dict(max_keyframes=16, max_points=1000, n_cams=2, feats_per_cam=N_FEATS, n_levels=1, scale_factor=1.2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    return make_world(n_points=500, n_frames=10, n_cams=2, n_feats=N_FEATS, noise_px=0.2, trajectory="line",
                      seed=1)


@pytest.fixture(scope="module")
def masks(world):
    return landmark_masks(world, seed=5)


@pytest.fixture(scope="module")
def frames(world, masks):
    return {t: masked_fields(world.frame_features(t), world, masks) for t in range(10)}


@pytest.fixture(scope="module")
def rigs(world):
    c = world.rig.cams
    trig = convert.rig_from_numpy(*(np.asarray(getattr(c, k)) for k in ("pol", "invpol", "cde", "pp", "wh")),
                                  np.asarray(world.rig.Mc_cayley), device="cpu")
    return world.rig, trig


def _min_dist(world, t):
    """The points' scale-invariance distances as the store keeps them for a
    level-0 observation from frame t (its body centre: within a rig's
    baseline of each camera)."""
    centre = cayley_to_hom_np(np.asarray(world.poses[t], np.float32))[:3, 3]
    return (np.linalg.norm(np.asarray(world.points) - centre, axis=1) * 0.95).astype(np.float32)


def _jf(f):
    return JF(**{k: jnp.asarray(v) for k, v in f.items()})


def _tf(f):
    return convert.frame_features_from_numpy(**f, device="cpu")


def test_masks_are_not_trivial(frames):
    v = frames[0]["valid"]
    m = frames[0]["dmask"][v]
    assert v.sum() > 300 and 0.8 < np.unpackbits(m).mean() < 0.9
    assert (frames[0]["dmask"][~v] == 255).all()


@pytest.mark.parametrize("check_rotation", [False, True], ids=["plain", "rotation"])
@pytest.mark.parametrize("t", [1, 4])
def test_match_window_frames_masked(frames, t, check_rotation):
    kw = dict(radius=100.0, th_desc=TH_LOW_MASKED, ratio=0.9, check_rotation=check_rotation, use_masks=True)
    ij, dj = (np.asarray(a) for a in jmatch_window(_jf(frames[0]), _jf(frames[t]), **kw))
    calls = []

    def recording(*a, **k):
        calls.append(k["mask_q"] is not None and k["mask_t"] is not None)
        return masked_best_match_cams_plain(*a, **k)
    it, dt = (a.numpy() for a in match_window_frames(_tf(frames[0]), _tf(frames[t]), match_fn=recording, **kw))
    assert calls == [True, True]
    np.testing.assert_array_equal(it, ij)
    ok = ij >= 0
    assert ok.sum() > 100
    np.testing.assert_array_equal(dt[ok], dj[ok])
    assert (np.mod(dt[ok] * 2, 1) == 0).all() and (dt[ok] <= TH_LOW_MASKED).all()


def test_bootstrap_masked_on_jax_draws(rigs, frames):
    key = jax.random.PRNGKey(0)
    rj, nj = jinit.bootstrap(rigs[0], _jf(frames[0]), _jf(frames[6]), key=key, use_masks=True)
    def sampler(c, n):
        return torch.tensor(np.asarray(jransac.sample_indices(jax.random.fold_in(key, c), 256, 8, n)))
    rt, nt = tinit.bootstrap(rigs[1], _tf(frames[0]), _tf(frames[6]), sampler=sampler, use_masks=True)
    assert nt == nj and nj >= 100
    assert rj is not None and rt is not None and rt.leading_cam == rj.leading_cam
    np.testing.assert_allclose(rt.Mt2, rj.Mt2, rtol=0, atol=1e-3)
    for a, b in ((rt.feat1, rj.feat1), (rt.feat2, rj.feat2)):
        assert len(set(a.tolist()) ^ set(b.tolist())) <= 0.01 * max(len(a), len(b))


def _kf_arrays(frames, ts):
    f = [frames[t] for t in ts]
    C, K = f[0]["valid"].shape
    return {n: np.stack([x[n] for x in f]) for n in ("uv", "rays", "desc", "dmask", "valid", "angle")}, C, K


@pytest.mark.parametrize("th", [TH_LOW_MASKED, 2.5])
def test_triangulate_pairs_masked(world, frames, th):
    """Keyframe 1 = frame 0, its neighbours frames 4 and 8, at the world's
    poses; at TH_LOW x0.5, and at 2.5, where the masked distance of a true
    match (the two frames' flipped bits under the landmark's mask) decides."""
    a, C, K = _kf_arrays(frames, (0, 4, 8))
    args = dict(uv1=a["uv"][0], rays1=a["rays"][0], desc1=a["desc"][0], free1=a["valid"][0],
                uv2s=a["uv"][1:], rays2s=a["rays"][1:], desc2s=a["desc"][1:], free2s=a["valid"][1:],
                ang1=a["angle"][0], ang2s=a["angle"][1:], dmask1=a["dmask"][0], dmask2s=a["dmask"][1:])
    mc6 = np.asarray(world.rig.Mc_cayley, np.float32)
    intr = np.asarray(world.rig.cams.to_vector())
    poses = np.asarray(world.poses, np.float32)
    ref = jlm.triangulate_pairs(jnp.asarray(mc6), jnp.asarray(poses[0]), jnp.asarray(poses[[4, 8]]),
                                **{n: jnp.asarray(v) for n, v in args.items()}, intr=jnp.asarray(intr),
                                th_desc=th, check_rotation=True, use_masks=True)
    got = tlm.triangulate_pairs(torch.tensor(mc6), torch.tensor(poses[0]), torch.tensor(poses[[4, 8]]),
                                **{n: torch.tensor(v) for n, v in args.items()}, intr=torch.tensor(intr),
                                th_desc=th, check_rotation=True, use_masks=True)
    ok = np.asarray(ref.ok)
    assert ok.sum() > 10
    np.testing.assert_array_equal(got.ok.numpy(), ok)
    np.testing.assert_array_equal(got.feat2.numpy()[ok], np.asarray(ref.feat2)[ok])
    np.testing.assert_allclose(got.X.numpy()[ok], np.asarray(ref.X)[ok], rtol=5e-4, atol=1e-4)
    one = tlm.triangulate_pair(torch.tensor(mc6), torch.tensor(poses[0]), torch.tensor(poses[4]),
                               *(torch.tensor(args[n]) for n in ("uv1", "rays1", "desc1", "free1")),
                               *(torch.tensor(args[n][0]) for n in ("uv2s", "rays2s", "desc2s", "free2s")),
                               torch.tensor(intr), th_desc=th, ang1=torch.tensor(args["ang1"]),
                               ang2=torch.tensor(args["ang2s"][0]), dmask1=torch.tensor(args["dmask1"]),
                               dmask2=torch.tensor(args["dmask2s"][0]), check_rotation=True, use_masks=True)
    assert torch.equal(one.packed, got.packed[0])


def test_fuse_match_masked(world, rigs, frames, masks):
    """The landmarks (their masks as the points' pt_dmask) projected into
    frames 3 and 6 as one tiled rig, as fuse_neighbors builds it."""
    a, C, K = _kf_arrays(frames, (3, 6))
    J = 2
    P = len(world.points)
    lp = dict(X=np.asarray(world.points, np.float32), desc=world.descs, min_dist=_min_dist(world, 3),
              max_dist=np.full(P, 25.0, np.float32), valid=np.ones(P, bool), normal=np.zeros((P, 3), np.float32),
              dmask=masks)
    poses = np.asarray(world.poses, np.float32)[[3, 6]]
    mc = hom_to_cayley_np(cayley_to_hom_np(poses)[:, None] @ np.asarray(world.rig.Mc, np.float64)[None])
    mc = mc.reshape(J * C, 6).astype(np.float32)
    f = {n: np.concatenate([frames[3][n], frames[6][n]]) for n in FIELDS}
    intr = np.asarray(world.rig.cams.to_vector())
    cams_j = jax.tree_util.tree_map(lambda x: jnp.tile(x, (J,) + (1,) * (x.ndim - 1)), world.rig.cams)
    ref = jlm.fuse_match(jnp.asarray(mc), jnp.tile(jnp.asarray(intr), (J, 1)), cams_j, _jf(f),
                         jnp.zeros(6, jnp.float32), JLP(**{n: jnp.asarray(v) for n, v in lp.items()}), 3.0,
                         use_masks=True)
    got = tlm.fuse_match(torch.tensor(mc), torch.tensor(intr).repeat(J, 1), rigs[1].cams.tile(J),
                         TF(**{n: torch.tensor(v) for n, v in f.items()}), torch.zeros(6),
                         TLP(**{n: torch.tensor(v) for n, v in lp.items()}), 3.0, use_masks=True)
    for name, x, y in zip(("assign", "dist", "keep"), ref[:3], got[:3]):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x), err_msg=name)
    keep = got[2].numpy()
    assert keep.sum() > 200 and (got[1].numpy()[keep] <= TH_LOW_MASKED).all()


def _stores(world, frames, masks, ts):
    """A JAX and a port MapStore holding frames ts as keyframes at their
    world poses and every landmark as a point."""
    stores = (JMapStore(JMapConfig(**MAP)), MapStore(MapConfig(**MAP)))
    for store, feats in zip(stores, (_jf, _tf)):
        for t in ts:
            store.add_keyframe(np.asarray(world.poses[t], np.float32), feats(frames[t]), float(t), t)
        min_dist = _min_dist(world, ts[0])
        for p in range(len(world.points)):
            store.add_point(np.asarray(world.points[p], np.float32), world.descs[p], masks[p], first_kf=0,
                            normal=np.zeros(3, np.float32), min_dist=min_dist[p], max_dist=25.0)
    return stores


def test_loop_sim3_candidate_matrix_masked(world, rigs, frames, masks):
    """LoopCloser._try_close's matches between the map-pointed features of
    two keyframes: the masked distance and TH_LOW x0.5, as the reference's
    inline branch (loop_closing.py:336-344) computes them."""
    js, ts = _stores(world, frames, masks, (2, 7))
    rng = np.random.default_rng(3)
    fk = np.sort(rng.choice(np.nonzero(ts.kf_feat_valid[0])[0], 120, replace=False))
    fc = np.sort(rng.choice(np.nonzero(ts.kf_feat_valid[1])[0], 140, replace=False))
    ref = np.asarray(jmatching.hamming_matrix_masked(
        jnp.asarray(js.kf_desc[0][fk]), jnp.asarray(js.kf_dmask[0][fk]),
        jnp.asarray(js.kf_desc[1][fc]), jnp.asarray(js.kf_dmask[1][fc])))
    lc = tlc.LoopCloser(ts, rigs[1], use_masks=True)
    d, th = lc._candidate_distances(0, 1, fk, fc)
    np.testing.assert_array_equal(d, ref)
    assert th == TH_LOW_MASKED == 1.0 * js.cfg.desc_bytes
    okm = (d.argmin(0)[d.argmin(1)] == np.arange(len(fk))) & (d.min(1) <= th)
    assert okm.sum() > 20
    d_plain, th_plain = tlc.LoopCloser(ts, rigs[1])._candidate_distances(0, 1, fk, fc)
    assert th_plain == 2.0 * B
    np.testing.assert_array_equal(d_plain, np.asarray(jmatching.hamming_matrix(
        jnp.asarray(js.kf_desc[0][fk]), jnp.asarray(js.kf_desc[1][fc]))))


def test_relocalization_candidate_matrix_masked(frames):
    """Relocalization's BoW-candidate matrix (system.py:838-855 of the
    reference): the frame's features against a candidate keyframe's
    map-pointed ones, masked, invalid features at 1e9; the best match and
    its TH_LOW x0.5 gate."""
    cur, cand = frames[5], frames[8]
    C, K, _ = cur["desc"].shape
    fk = np.nonzero(cand["valid"].reshape(-1))[0][::2]
    cdesc, cmask = cand["desc"].reshape(-1, B)[fk], cand["dmask"].reshape(-1, B)[fk]
    ref = np.array(jmatching.hamming_matrix_masked(jnp.asarray(cur["desc"].reshape(-1, B)),
                                                   jnp.asarray(cur["dmask"].reshape(-1, B)),
                                                   jnp.asarray(cdesc), jnp.asarray(cmask)))
    got = tmatching.hamming_matrix_masked(torch.tensor(cur["desc"].reshape(-1, B)),
                                          torch.tensor(cur["dmask"].reshape(-1, B)), torch.tensor(cdesc),
                                          torch.tensor(cmask)).numpy()
    np.testing.assert_array_equal(got, ref)
    for d in (ref, got):
        d[~cur["valid"].reshape(-1)] = 1e9
    np.testing.assert_array_equal(got.argmin(1), ref.argmin(1))
    ok = got.min(1) <= TH_LOW_MASKED
    assert ok.sum() >= 15
    np.testing.assert_array_equal(ok, ref.min(1) <= TH_LOW_MASKED)


def test_project_loop_points_stays_unmasked(world, rigs, frames, masks, monkeypatch):
    """The loop's projection search (Sim3 check and SearchAndFuse) matches
    without the masks at the unmasked TH_LOW in both packages, even when
    the loop closer has use_masks (the reference's, reproduced): neither
    passes use_masks to fuse_match, and both find the same matches."""
    js, ts = _stores(world, frames, masks, (2,))
    seen = {"jax": [], "port": []}

    def spy(fn, key):
        def wrapped(*a, **kw):
            seen[key].append(kw.get("use_masks", False))
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(jlm, "fuse_match", spy(jlm.fuse_match, "jax"))
    monkeypatch.setattr(tlc, "fuse_match", spy(tlc.fuse_match, "port"))
    pts = np.arange(len(world.points))
    pose = np.asarray(world.poses[2], np.float32)
    ref = jlc.LoopCloser(js, rigs[0], use_masks=True)._project_loop_points(0, pose, pts)
    got = tlc.LoopCloser(ts, rigs[1], use_masks=True)._project_loop_points(0, pose, pts)
    assert seen == {"jax": [False], "port": [False]}
    np.testing.assert_array_equal(got, ref)
    assert (got >= 0).sum() > 100
