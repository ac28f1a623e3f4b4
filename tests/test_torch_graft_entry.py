"""The port's graft entry (multicol_slam_tpu_torch/graft_entry.py) against
the repository's __graft_entry__.py on the CPU.

entry(): the same numpy inputs (images from default_rng(0), pose0 zeros)
and the same local map (the world's first 512 landmarks). On the JAX
package's features carried across with convert.py, the step is held to the
reference's result: n_inliers equal, pose within 1e-4. On the port's own
extraction, held to the extraction agreement of ROADMAP Queue 3, Slice 1
(>= 99 % keypoints and descriptor bits; the pyramid sums in another order)
and to the reference's result. On these noise images the step matches no
landmark in either package (0 inliers, pose0 back): the reference's entry
is a compile check. So the step is also held where it tracks: the world's
own frame features, put on the pyramid level the map predicts, from a
perturbed start pose: inliers equal and pose within 1e-4.

dryrun_multichip(): its asserts hold in a group of one rank that it opens
itself; tests/test_torch_parallel.py::test_dryrun_asserts runs it over two
and four gloo ranks (tests/torch_multihost_worker.py's dryrun job)."""
import dataclasses
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from multicol_slam_tpu.io.synthetic import make_world as jmake_world
from multicol_slam_tpu.slam.features import extract_features as jextract
from multicol_slam_tpu.slam.tracking_kernels import track_stage as jtrack_stage
from multicol_slam_tpu.utils.config import ExtractorSettings as JSettings
from multicol_slam_tpu_torch import convert, graft_entry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("uv", "response", "octave", "angle", "rays", "desc", "dmask", "valid")
POSE_TOL = 1e-4
POSE_NOISE = [0.002, -0.003, 0.002, 0.02, -0.015, 0.01]   # ~0.5 deg, ~3 cm off the world's frame-0 pose


@pytest.fixture(scope="module")
def reference():
    """The root __graft_entry__.entry()'s (fn, args), and the world and
    settings it is built from (its recipe, __graft_entry__.py:27-51)."""
    mp = pytest.MonkeyPatch()
    import multicol_slam_tpu.utils.jaxcache as jaxcache

    try:
        mp.setattr(jaxcache, "enable_compile_cache", lambda *a, **k: None)
        mp.syspath_prepend(ROOT)
        ref = importlib.import_module("__graft_entry__")
        fn, args = ref.entry()
    finally:
        mp.undo()
        sys.modules.pop("__graft_entry__", None)
    world = jmake_world(n_points=512, n_frames=2, n_cams=3, n_feats=128, seed=0)
    return fn, args, world, JSettings(n_features=128, n_levels=4, scale_factor=1.2, fast_th=15)


@pytest.fixture(scope="module")
def port():
    return graft_entry.flagship(device="cpu")


def _port_feats(f):
    return convert.frame_features_from_numpy(**{k: np.asarray(getattr(f, k)) for k in FIELDS}, device="cpu")


def _jax_step(world, feats, pose0):
    """The reference's track_stage call (__graft_entry__.py:45-47) on feats."""
    rig = world.rig
    L = graft_entry.L
    from multicol_slam_tpu.slam.tracking_kernels import LocalPoints as JLocalPoints

    pts = JLocalPoints(X=jnp.asarray(world.points[:L].astype(np.float32)), desc=jnp.asarray(world.descs[:L]),
                       min_dist=jnp.full((L,), 0.5), max_dist=jnp.full((L,), 25.0), valid=jnp.ones((L,), bool))
    out = jtrack_stage(jnp.asarray(np.asarray(rig.Mc_cayley, np.float32)), jnp.asarray(rig.cams.to_vector()),
                       rig.cams, feats, jnp.asarray(pose0), pts, scale_factor=1.2, n_levels=4, radius=15.0,
                       th_desc=96.0)
    return np.asarray(out.pose), int(out.n_inliers)


def test_entry_inputs_are_the_references(reference, port):
    fn, args, _, _ = reference
    _, _, (images, pose0) = port
    np.testing.assert_array_equal(images.numpy(), np.asarray(args[0]))
    np.testing.assert_array_equal(pose0.numpy(), np.asarray(args[1]))
    _, args_t = graft_entry.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args_t)


def test_step_on_the_reference_features(reference, port):
    """The step after extraction on the JAX package's features of the
    entry's images: the reference's n_inliers, pose within 1e-4."""
    _, args, world, settings = reference
    _, track, (_, pose0) = port
    fj = jextract(args[0], world.rig.cams, settings)
    pose_j, n_j = _jax_step(world, fj, np.zeros(6, np.float32))
    pose_t, n_t = track(_port_feats(fj), pose0)
    assert int(n_t) == n_j
    np.testing.assert_allclose(pose_t.numpy(), pose_j, rtol=0, atol=POSE_TOL)


def test_step_tracks_the_world_frame(reference, port):
    """The step where it really tracks: the world's own frame-0 features
    (the JAX package's, carried across with convert.py) from a perturbed
    start pose, against the same local map in both packages. The world's
    keypoints are all on octave 0; the map's distance band (max 25 m)
    predicts the top level of the 4 for its landmarks (6-12 m away), so the
    features are put there. Inliers found and equal, pose within 1e-4."""
    _, _, world, settings = reference
    _, track, _ = port
    f = world.frame_features(0)
    fj = dataclasses.replace(f, octave=jnp.full_like(f.octave, settings.n_levels - 1))
    pose0 = (world.poses[0] + np.asarray(POSE_NOISE, np.float32)).astype(np.float32)
    pose_j, n_j = _jax_step(world, fj, pose0)
    pose_t, n_t = track(_port_feats(fj), torch.tensor(pose0))
    assert n_j >= 0.9 * int(np.asarray(fj.valid).sum())
    assert int(n_t) == n_j
    np.testing.assert_allclose(pose_t.numpy(), pose_j, rtol=0, atol=POSE_TOL)


def test_entry_on_its_own_extraction(reference, port):
    """fn(*args) end to end (one K1 launch: the plain version on the CPU),
    against the reference's jitted fn; its extraction within the ±1 %
    agreement of the JAX package's."""
    fn_j, args_j, world, settings = reference
    extract, track, (images, pose0) = port
    pose_j, n_j = (np.asarray(x) for x in jax.jit(fn_j)(*args_j))
    fn, args = graft_entry.entry(device="cpu")
    pose_t, n_t = fn(*args)
    assert int(n_t) == int(n_j)
    np.testing.assert_allclose(pose_t.numpy(), pose_j, rtol=0, atol=POSE_TOL)
    fj = jextract(args_j[0], world.rig.cams, settings)
    ft = extract(images)
    n_kp = n_shared = bits = bits_equal = 0
    for c in range(graft_entry.C):
        key = lambda f, i: (int(f.octave[c, i]), float(f.uv[c, i, 0]), float(f.uv[c, i, 1]))  # noqa: E731
        kj = {key(fj, i): i for i in np.nonzero(np.asarray(fj.valid[c]))[0]}
        kt = {key(ft, i): i for i in np.nonzero(ft.valid[c].numpy())[0]}
        shared = kj.keys() & kt.keys()
        n_kp += max(len(kj), len(kt))
        n_shared += len(shared)
        for k in shared:
            x = np.unpackbits(np.asarray(fj.desc[c, kj[k]]) ^ ft.desc[c, kt[k]].numpy())
            bits += x.size
            bits_equal += x.size - int(x.sum())
    assert n_kp > 0.8 * graft_entry.C * settings.n_features
    assert n_shared >= 0.99 * n_kp and bits_equal >= 0.99 * bits, (n_shared, n_kp, bits_equal, bits)


def test_dryrun_one_rank_opens_its_group():
    assert not dist.is_initialized()
    out = graft_entry.dryrun_multichip(1, device="cpu")
    assert not dist.is_initialized()
    for layout in ("rows", "points"):
        params, cost = out[layout]
        assert float(cost) < 0.5 * out["cost0"]
        np.testing.assert_array_equal(params.poses.numpy(), out["single"][0].poses.numpy())
    with pytest.raises(ValueError, match="no process group"):
        graft_entry.dryrun_multichip(2, device="cpu")
