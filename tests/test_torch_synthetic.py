"""Port parity of the synthetic world and its renderer: the port's
`make_world` arrays equal the JAX package's exactly for the same arguments,
and so do the `render_frame` images, pixel for pixel (the landmark
projection is float32 on both sides and rounds to the same stamp centres),
on the small synthetic rig and on the 754 x 480 Lafida-shaped rig of the
bootstrap phase of chip_smoke.py."""
import numpy as np
import pytest

from multicol_slam_tpu.io import render as jrender
from multicol_slam_tpu.io import synthetic as jsynthetic
from multicol_slam_tpu_torch import convert
from multicol_slam_tpu_torch.io import render as trender
from multicol_slam_tpu_torch.io import synthetic as tsynthetic

ARRAYS = ("points", "descs", "poses", "timestamps")
WORLDS = {
    "ring_circle": dict(n_points=400, n_frames=6, n_cams=3, n_feats=200, seed=3),
    "room_circle_noyaw": dict(n_points=400, n_frames=6, n_cams=3, n_feats=200, noise_px=0.0,
                              trajectory="circle_noyaw", radius=3.0, seed=12, period=400,
                              landmarks="room", max_vis_dist=12.0),
    "corridor_line": dict(n_points=300, n_frames=8, n_cams=2, n_feats=150, trajectory="line",
                          landmarks="corridor", seed=5),
    "path_outback": dict(n_points=300, n_frames=8, n_cams=2, n_feats=150, trajectory="outback",
                         landmarks="path", seed=6),
    "pathroom_circle": dict(n_points=300, n_frames=4, n_cams=3, n_feats=150, landmarks="pathroom", seed=7),
}


def _rig(jrig):
    c = jrig.cams
    return convert.rig_from_numpy(*(np.asarray(getattr(c, k)) for k in ("pol", "invpol", "cde", "pp", "wh")),
                                  np.asarray(jrig.Mc_cayley), device="cpu")


@pytest.mark.parametrize("name", list(WORLDS))
def test_make_world_arrays_exact(name):
    jw = jsynthetic.make_world(**WORLDS[name])
    tw = tsynthetic.make_world(**WORLDS[name])
    for k in ARRAYS:
        a, b = getattr(tw, k), getattr(jw, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=f"{name}: {k}")
    assert (tw.n_feats, tw.noise_px, tw.seed, tw.max_vis_dist) == (jw.n_feats, jw.noise_px, jw.seed,
                                                                   jw.max_vis_dist)
    jr, tr = jw.rig, tw.rig
    for k in ("pol", "invpol", "cde", "pp", "wh"):
        np.testing.assert_allclose(getattr(tr.cams, k).numpy(), np.asarray(getattr(jr.cams, k)),
                                   rtol=1e-6, atol=0, err_msg=k)
    np.testing.assert_array_equal(tr.Mc_cayley.numpy(), np.asarray(jr.Mc_cayley))
    np.testing.assert_allclose(tr.Mc.numpy(), np.asarray(jr.Mc), rtol=0, atol=1e-6)


def _lafida_rigs():
    """The 754 x 480 rig of bench.py:51-62 (and chip_smoke.py), both packages."""
    from multicol_slam_tpu.models.camera import OmniCamera as JCam
    from multicol_slam_tpu.models.rig import MultiCamRig as JRig

    C, H, W = 3, 480, 754
    args = ([[-209.2, 0.0, 0.0021, -4.2e-06, 1.77e-08]] * C,
            [[293.7, 150.0, -10.4, 28.2, 7.1, 0.06, 10.4, 0.17, -5.9, 1.18, 3.1, 0.81]] * C,
            [[1.0, 0.0, 0.0]] * C, [[W / 2.0, H / 2.0]] * C, [[W, H]] * C)
    mc = np.zeros((C, 6), np.float32)
    mc[1, 3], mc[2, 4] = 0.2, 0.2
    jrig = JRig.from_cayley(JCam.from_params(*args), mc)
    return jrig, _rig(jrig)


@pytest.mark.parametrize("name,t", [("ring_circle", 0), ("ring_circle", 5),
                                    ("room_circle_noyaw", 3), ("corridor_line", 7)])
def test_render_frame_pixels_exact(name, t):
    jw = jsynthetic.make_world(**WORLDS[name])
    tw = convert.world_from_numpy(*(getattr(jw, k) for k in ARRAYS), jw.n_feats, jw.noise_px,
                                  jw.seed, jw.max_vis_dist, _rig(jw.rig))
    a = trender.render_frame(tw, t)
    b = jrender.render_frame(jw, t)
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    np.testing.assert_array_equal(a, b, err_msg=f"{name} t={t}")
    assert (b != 20).mean() > 0.02, "the frame shows landmarks"


def test_render_frame_sensor_noise_exact():
    kw = dict(WORLDS["ring_circle"], noise_px=0.5)
    jw = jsynthetic.make_world(**kw)
    tw = tsynthetic.make_world(**kw)
    np.testing.assert_array_equal(trender.render_frame(tw, 2), jrender.render_frame(jw, 2))


def test_bootstrap_world_at_lafida_width_exact():
    """chip_smoke.py's bootstrap world (bench.py:207-211) at 754 x 480."""
    jrig, trig = _lafida_rigs()
    kw = dict(n_points=3000, n_frames=4, n_cams=3, n_feats=400, noise_px=0.0,
              trajectory="circle_noyaw", radius=3.0, seed=12, period=400, landmarks="room",
              max_vis_dist=12.0)
    jw = jsynthetic.make_world(**kw, rig=jrig)
    tw = tsynthetic.make_world(**kw, rig=trig)
    for k in ARRAYS:
        np.testing.assert_array_equal(getattr(tw, k), getattr(jw, k), err_msg=k)
    a, b = trender.render_frame(tw, 3), jrender.render_frame(jw, 3)
    assert a.shape == (3, 480, 754)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,t", [("ring_circle", 0), ("ring_circle", 4), ("corridor_line", 6),
                                    ("room_circle_noyaw", 2)])
def test_synthesize_features(name, t):
    """The oracle features of a frame (`SyntheticWorld.frame_features`): the
    same landmarks in the same slots with the same descriptors (exactly:
    the same generator draws, float32 projections that round alike), pixels
    and rays within 1e-4."""
    jw = jsynthetic.make_world(**WORLDS[name])
    tw = convert.world_from_numpy(*(getattr(jw, k) for k in ARRAYS), jw.n_feats, jw.noise_px,
                                  jw.seed, jw.max_vis_dist, _rig(jw.rig))
    a = tw.frame_features(t, device="cpu")
    b = jw.frame_features(t)
    for k in ("response", "octave", "angle", "desc", "dmask", "valid"):
        np.testing.assert_array_equal(getattr(a, k).numpy(), np.asarray(getattr(b, k)), err_msg=k)
    np.testing.assert_allclose(a.uv.numpy(), np.asarray(b.uv), rtol=0, atol=1e-4)
    np.testing.assert_allclose(a.rays.numpy(), np.asarray(b.rays), rtol=0, atol=1e-4)
    assert int(a.valid.sum()) > 50
