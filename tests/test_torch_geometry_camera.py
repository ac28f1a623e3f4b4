"""Port parity: geometry, omni camera and rig (multicol_slam_tpu_torch vs
multicol_slam_tpu) on the same numpy inputs. Floats agree within 1e-5
relative (float32 arithmetic in another order); masks exactly."""
import jax.numpy as jnp
import numpy as np
import torch

from multicol_slam_tpu.io.synthetic import make_synthetic_rig
from multicol_slam_tpu.models import camera as jcam
from multicol_slam_tpu.utils import geometry as jgeo
from multicol_slam_tpu_torch import convert
from multicol_slam_tpu_torch.models import camera as tcam
from multicol_slam_tpu_torch.utils import geometry as tgeo

RTOL, ATOL = 1e-5, 1e-6


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol, atol=atol)


def _rig():
    jrig = make_synthetic_rig(n_cams=3, w=256, h=192)
    c = jrig.cams
    trig = convert.rig_from_numpy(
        *(np.asarray(getattr(c, k)) for k in ("pol", "invpol", "cde", "pp", "wh")),
        np.asarray(jrig.Mc_cayley), device="cpu")
    return jrig, trig


def test_cayley_hom_inverse_transform():
    rng = np.random.default_rng(0)
    c6 = rng.normal(0, 0.5, (5, 7, 6)).astype(np.float32)
    X = rng.normal(0, 3, (5, 7, 3)).astype(np.float32)
    _close(jgeo.cayley_to_rot(jnp.asarray(c6[..., :3])), tgeo.cayley_to_rot(torch.tensor(c6[..., :3])))
    Mj = jgeo.cayley_to_hom(jnp.asarray(c6))
    Mt = tgeo.cayley_to_hom(torch.tensor(c6))
    _close(Mj, Mt)
    _close(jgeo.hom_inverse(Mj), tgeo.hom_inverse(Mt))
    _close(jgeo.transform_points(Mj, jnp.asarray(X)), tgeo.transform_points(Mt, torch.tensor(X)))


def test_horner_and_derivative():
    rng = np.random.default_rng(1)
    coeffs = rng.normal(0, 1, (4, 12)).astype(np.float32)
    x = rng.uniform(-1.5, 1.5, (4, 9)).astype(np.float32)
    _close(jgeo.horner(jnp.asarray(coeffs)[:, None], jnp.asarray(x)),
           tgeo.horner(torch.tensor(coeffs)[:, None], torch.tensor(x)), rtol=1e-5, atol=1e-5)
    xd = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    y = tgeo.horner(torch.tensor(coeffs, dtype=torch.float64)[:, None], xd)
    (g,) = torch.autograd.grad(y.sum(), xd)
    d = tgeo.horner_deriv(torch.tensor(coeffs, dtype=torch.float64)[:, None], xd.detach())
    np.testing.assert_allclose(d.numpy(), g.numpy(), rtol=1e-12)


def test_projection_unprojection_and_vector_layout():
    jrig, trig = _rig()
    rng = np.random.default_rng(2)
    C = 3
    Xc = (rng.normal(0, 1, (C, 50, 3)) + np.array([0, 0, 2.0])).astype(np.float32)
    jc, tc = jrig.cams, trig.cams
    uv_j = jcam.rig_world_to_img(jc, jnp.asarray(Xc))
    uv_t = tcam.world_to_img(tc.invpol[:, None], tc.cde[:, None], tc.pp[:, None], torch.tensor(Xc))
    _close(uv_j, uv_t, rtol=1e-5, atol=1e-3)
    uv = np.asarray(uv_j)
    rays_j = jcam.rig_img_to_world(jc, jnp.asarray(uv))
    rays_t = tcam.img_to_world(tc.pol[:, None], tc.cde[:, None], tc.pp[:, None], torch.tensor(uv))
    _close(rays_j, rays_t, rtol=1e-5, atol=1e-6)
    _close(jc.to_vector(), tc.to_vector())
    back = tcam.OmniCamera.from_vector(tc.to_vector(), tc.wh)
    back_j = jcam.OmniCamera.from_vector(jc.to_vector(), jc.wh)
    for k in ("pol", "invpol", "cde", "pp"):
        np.testing.assert_array_equal(getattr(back, k).numpy(), np.asarray(getattr(back_j, k)))
    _close(jrig.Mc, trig.Mc)


def test_mirror_masks_equal():
    jrig, trig = _rig()
    rng = np.random.default_rng(3)
    uv = np.stack([rng.uniform(-20, 280, (3, 400)), rng.uniform(-20, 210, (3, 400))], -1).astype(np.float32)
    ids = np.arange(3)[:, None]
    for scale in (1.0, 1.2 ** -2):
        m_j = jcam.in_mirror_mask(jrig.cams, jnp.asarray(ids), jnp.asarray(uv), scale)
        m_t = tcam.in_mirror_mask(trig.cams, torch.tensor(ids), torch.tensor(uv), scale)
        np.testing.assert_array_equal(np.asarray(m_j), m_t.numpy())
    for level, (h, w) in enumerate([(192, 256), (133, 178)]):
        s = 1.2 ** (-2 * level)
        g_j = jcam.mirror_mask_grid(jrig.cams, h, w, scale=s)
        g_t = tcam.mirror_mask_grid(trig.cams, h, w, scale=s)
        np.testing.assert_array_equal(np.asarray(g_j), g_t.numpy())


def test_rot_hom_to_cayley_and_skew():
    rng = np.random.default_rng(4)
    c6 = rng.normal(0, 0.5, (6, 6)).astype(np.float32)
    Mj = jgeo.cayley_to_hom(jnp.asarray(c6))
    Mt = tgeo.cayley_to_hom(torch.tensor(c6))
    _close(jgeo.rot_to_cayley(Mj[:, :3, :3]), tgeo.rot_to_cayley(Mt[:, :3, :3]), rtol=1e-5, atol=1e-5)
    _close(jgeo.hom_to_cayley(Mj), tgeo.hom_to_cayley(Mt), rtol=1e-5, atol=1e-5)
    _close(c6, tgeo.hom_to_cayley(Mt), rtol=1e-4, atol=1e-5)   # the round trip
    v = rng.normal(size=(4, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(tgeo.skew(torch.tensor(v)).numpy(), np.asarray(jgeo.skew(jnp.asarray(v))))


def test_essential_epipolar_and_quaternion():
    """The mapping's epipolar gate and the trajectory writer's quaternion."""
    rng = np.random.default_rng(6)
    c6 = rng.normal(0, 0.5, (2, 4, 6)).astype(np.float32)
    Mj, Mt = jgeo.cayley_to_hom(jnp.asarray(c6)), tgeo.cayley_to_hom(torch.tensor(c6))
    Ej, Et = jgeo.essential_from_relative(Mj), tgeo.essential_from_relative(Mt)
    _close(Ej, Et, rtol=1e-5, atol=1e-5)
    r1 = rng.normal(size=(2, 4, 3)).astype(np.float32)
    r2 = rng.normal(size=(2, 4, 3)).astype(np.float32)
    r1 /= np.linalg.norm(r1, axis=-1, keepdims=True)
    r2 /= np.linalg.norm(r2, axis=-1, keepdims=True)
    _close(jgeo.ray_epipolar_distance(jnp.asarray(r1), Ej, jnp.asarray(r2)),
           tgeo.ray_epipolar_distance(torch.tensor(r1), Et, torch.tensor(r2)), rtol=1e-5, atol=1e-5)
    # every Shepperd branch: identity, then half-turns about x, y and z
    R = np.concatenate([np.asarray(Mj)[..., :3, :3].reshape(-1, 3, 3),
                        np.stack([np.eye(3), np.diag([1, -1, -1]), np.diag([-1, 1, -1]),
                                  np.diag([-1, -1, 1])]).astype(np.float32)])
    _close(jgeo.rot_to_quat(jnp.asarray(R)), tgeo.rot_to_quat(torch.tensor(R)), rtol=1e-5, atol=1e-6)


def test_cam_indexed_projection_and_fit_inverse_poly():
    jrig, trig = _rig()
    rng = np.random.default_rng(5)
    X = (rng.normal(0, 1, (80, 3)) + np.array([0, 0, 2.0])).astype(np.float32)
    ids = rng.integers(0, 3, 80)
    for cam_idx in (1, ids):
        uv_j = jcam.cam_world_to_img(jrig.cams, jnp.asarray(cam_idx), jnp.asarray(X))
        uv_t = tcam.cam_world_to_img(trig.cams, torch.as_tensor(cam_idx), torch.tensor(X))
        _close(uv_j, uv_t, rtol=1e-5, atol=1e-3)
        rays_j = jcam.cam_img_to_world(jrig.cams, jnp.asarray(cam_idx), uv_j)
        rays_t = tcam.cam_img_to_world(trig.cams, torch.as_tensor(cam_idx), torch.tensor(np.asarray(uv_j)))
        _close(rays_j, rays_t)
    pol = [-209.2, 0.0, 0.0021, -4.2e-06, 1.77e-08]
    np.testing.assert_array_equal(tcam.fit_inverse_poly(pol, 300.0), jcam.fit_inverse_poly(pol, 300.0))
