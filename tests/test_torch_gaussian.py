"""The port's 3DGS frontend and helpers against the JAX package on the CPU:
quaternion rotations, 3D covariances, the EWA projection, SH color, the kNN
scale init, 30-bit Morton codes, the log-lerp LR schedules (with the
delayed warm-up) and DSSIM.
Inputs come from numpy seeds; tolerances are stated per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.cameras.pose import quaternion_to_rotation_matrix as t_q2r
from nerficg_torch.ops import encoding as t_enc
from nerficg_torch.ops import gaussian as t_gauss
from nerficg_torch.ops.knn import knn_mean_sq_distance as t_knn
from nerficg_torch.ops.morton import morton_encode_positions as t_morton
from nerficg_torch.optim.losses import dssim as t_dssim
from nerficg_torch.optim.lr import exponential_decay as t_exp
from nerficg_torch.optim.lr import lr_decay_policy as t_lr
from nerficg_tpu.cameras.pose import quaternion_to_rotation_matrix as j_q2r
from nerficg_tpu.ops import encoding as j_enc
from nerficg_tpu.ops import gaussian as j_gauss
from nerficg_tpu.ops.knn import knn_mean_sq_distance as j_knn
from nerficg_tpu.ops.morton import morton_encode_positions as j_morton
from nerficg_tpu.optim.losses import dssim as j_dssim
from nerficg_tpu.optim.lr import exponential_decay as j_exp
from nerficg_tpu.optim.lr import lr_decay_policy as j_lr
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_rotation_and_covariance():
    """f32 elementwise products and a 3x3 product: atol 1e-6."""
    rng = np.random.default_rng(0)
    q = _quats(rng, 64)
    scales = np.exp(rng.uniform(-4, 0, (64, 3))).astype(np.float32)
    np.testing.assert_allclose(
        t_gauss.quaternion_to_rotation(torch.tensor(q)).numpy(),
        np.asarray(j_gauss.quaternion_to_rotation(jnp.asarray(q))), atol=1e-6)
    np.testing.assert_allclose(
        t_gauss.build_covariance_3d(torch.tensor(scales),
                                    torch.tensor(q)).numpy(),
        np.asarray(j_gauss.build_covariance_3d(jnp.asarray(scales),
                                               jnp.asarray(q))), atol=1e-6)
    np.testing.assert_allclose(t_q2r(q), j_q2r(q), atol=1e-12)


def test_projection_matches_jax():
    """Means, depths and radii within 1e-4 px; conics within 1e-5 relative;
    the same culling; Gaussians behind the camera included."""
    rng = np.random.default_rng(1)
    n = 500
    means = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    q = _quats(rng, n)
    scales = np.exp(rng.uniform(-4, -1, (n, 3))).astype(np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 2.5
    args = (120.0, 110.0, 64.0, 48.0, 128, 96)
    cov_t = t_gauss.build_covariance_3d(torch.tensor(scales), torch.tensor(q))
    cov_j = j_gauss.build_covariance_3d(jnp.asarray(scales), jnp.asarray(q))
    got = t_gauss.project_gaussians(torch.tensor(means), cov_t,
                                    torch.tensor(w2c), *args)
    want = j_gauss.project_gaussians(jnp.asarray(means), cov_j,
                                     jnp.asarray(w2c), *args)
    assert (got['means2d'][:, 0] > 0).any() and (~got['in_frustum']).any()
    np.testing.assert_array_equal(got['in_frustum'].numpy(),
                                  np.asarray(want['in_frustum']))
    for key, tol in (('means2d', 1e-4), ('depths', 1e-6), ('radii', 1e-4)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=tol, err_msg=key)
    np.testing.assert_allclose(got['conics'].numpy(),
                               np.asarray(want['conics']), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize('degree', [1, 2, 3, 4])
def test_eval_sh_matches_jax(degree):
    """atol 1e-6 over 16 coefficients per channel."""
    rng = np.random.default_rng(degree)
    coeffs = rng.normal(size=(100, 16, 3)).astype(np.float32)
    dirs = rng.normal(size=(100, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        t_enc.eval_sh(torch.tensor(coeffs), torch.tensor(dirs),
                      degree).numpy(),
        np.asarray(j_enc.eval_sh(jnp.asarray(coeffs), jnp.asarray(dirs),
                                 degree)), atol=1e-6)


def test_knn_matches_jax():
    """The k-d tree's exact k=3 distances against the JAX package's (its
    sklearn or brute-force path, f32): rtol 1e-5; duplicates included."""
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    pts[10] = pts[11]
    np.testing.assert_allclose(t_knn(pts, 3), j_knn(pts, 3), rtol=1e-5,
                               atol=1e-9)
    few = pts[:3]
    np.testing.assert_allclose(t_knn(few, 3), j_knn(few, 3), rtol=1e-6)


def test_morton_codes_match_jax():
    """Bit-equal 30-bit codes, points on the box's faces included."""
    rng = np.random.default_rng(3)
    pos = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
    lo, hi = pos.min(0), pos.max(0)
    got = t_morton(torch.tensor(pos), torch.tensor(lo), torch.tensor(hi))
    want = np.asarray(j_morton(jnp.asarray(pos), jnp.asarray(lo),
                               jnp.asarray(hi)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_lr_decay_policy_matches_jax():
    """Python float math against JAX's f32: rtol 1e-6."""
    t_fn = t_lr(1.6e-4 * 3.3, 1.6e-6 * 3.3, 30000)
    j_fn = j_lr(1.6e-4 * 3.3, 1.6e-6 * 3.3, 30000)
    for step in (0, 1, 50, 999, 15000, 30000, 40000):
        np.testing.assert_allclose(t_fn(step), float(j_fn(step)), rtol=1e-6)


@pytest.mark.parametrize('delay_steps,delay_mult', [(0, 0.5), (2500, 0.01),
                                                    (1000, 1.0)])
def test_lr_decay_policy_delay_matches_jax(delay_steps, delay_mult):
    """The cosine-delayed warm-up (and its absence at 0 delay steps)
    against JAX's f32, before, during and after the delay: rtol 1e-6."""
    args = (5e-4, 5e-6, 10000, delay_steps, delay_mult)
    t_fn, j_fn = t_lr(*args), j_lr(*args)
    for step in (0, 1, 10, 500, 999, 1000, 2499, 2500, 5000, 10000, 15000):
        np.testing.assert_allclose(t_fn(step), float(j_fn(step)), rtol=1e-6)


@pytest.mark.parametrize('lr_init,lr_final,max_steps', [
    (1e-2, 1e-4, 1000), (5e-3, 5e-3, 300), (1e-3, 3e-2, 777)])
def test_exponential_decay_matches_jax(lr_init, lr_final, max_steps):
    """The log-linear decay against JAX's over steps 0..1.5 max_steps,
    the clamp past max_steps included: rtol 1e-6."""
    t_fn = t_exp(lr_init, lr_final, max_steps)
    j_fn = j_exp(lr_init, lr_final, max_steps)
    for step in range(0, max_steps * 3 // 2 + 1):
        np.testing.assert_allclose(t_fn(step), float(j_fn(step)), rtol=1e-6)
    assert t_fn(max_steps * 3 // 2) == pytest.approx(lr_final, rel=1e-12)


def test_dssim_and_its_gradient_match_jax():
    """The loss within 1e-6, its gradient within 1e-6 absolute."""
    rng = np.random.default_rng(4)
    pred = rng.uniform(0, 1, (40, 36, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (40, 36, 3)).astype(np.float32)
    p = torch.tensor(pred, requires_grad=True)
    loss = t_dssim(p, torch.tensor(target))
    loss.backward()
    want, grad = jax.value_and_grad(j_dssim)(jnp.asarray(pred),
                                             jnp.asarray(target))
    np.testing.assert_allclose(float(loss.detach()), float(want), atol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(grad), atol=1e-6)


INTRINSICS = (120.0, 110.0, 64.0, 48.0, 128, 96)


def _camera(dtype):
    """A turned camera 2.5 in front of the origin: (w2c, its position)."""
    rot = t_gauss.quaternion_to_rotation(
        torch.tensor([0.9, 0.2, -0.3, 0.25], dtype=torch.float64) /
        np.sqrt(0.9 ** 2 + 0.2 ** 2 + 0.3 ** 2 + 0.25 ** 2))
    w2c = torch.eye(4, dtype=torch.float64)
    w2c[:3, :3] = rot
    w2c[:3, 3] = torch.tensor([0.1, -0.2, 2.5], dtype=torch.float64)
    return w2c.to(dtype), (-rot.T @ w2c[:3, 3]).to(dtype)


def _frontend_params(rng, dtype, n=400, stored=16):
    """Raw parameters of ``n`` Gaussians (``stored`` SH coefficients),
    random in the camera's view, whose last rows hold each edge of the
    backward: padding rows (zero quaternions), points behind ``near``,
    points past the tan-fov clamp, needles (two scales under 0.0025:
    det <= 0 at a negative low pass), colours under -0.5, and raw scales
    past and on the -15 / 10 clamp (the other two scales distinct and
    within a factor e^3 of it, so that the covariance's gradient stays well
    conditioned)."""
    w2c, _ = _camera(torch.float64)
    cam = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.4, 0.4, n),
                    rng.uniform(1.0, 4.0, n)], -1)
    scales = rng.uniform(-4.0, -1.0, (n, 3))
    rotations = rng.normal(size=(n, 4))
    opacities = rng.normal(size=(n, 1))
    dc = rng.normal(scale=0.5, size=(n, 1, 3))
    rest = rng.normal(scale=0.3, size=(n, stored - 1, 3))
    e = n - 64
    cam[e:e + 8, 2] = rng.uniform(-1.0, 0.005, 8)            # behind near
    cam[e + 8:e + 16, 0] = cam[e + 8:e + 16, 2] * rng.choice(
        [-1.0, 1.0], 8) * rng.uniform(0.8, 2.0, 8)           # past lim_x
    cam[e + 16:e + 24, 1] = cam[e + 16:e + 24, 2] * rng.choice(
        [-1.0, 1.0], 8) * rng.uniform(0.7, 2.0, 8)           # past lim_y
    scales[e + 24:e + 32] = [-6.0, -6.5, -1.0]               # needles
    dc[e + 32:e + 40] = -3.0                                 # colour < -0.5
    rest[e + 32:e + 40] = 0.0
    scales[e + 40:e + 48, 0] = [-17.0, -16.0, -15.0, -15.0, 10.0, 10.0,
                                11.0, 12.0]                  # at the clamp
    scales[e + 40:e + 44, 1:] = [-2.5, -1.0]
    scales[e + 44:e + 48, 1:] = [9.0, 9.5]
    positions = (cam - w2c[:3, 3].numpy()) @ w2c[:3, :3].numpy()
    positions[e + 56:] = 0.0                                 # padding rows
    scales[e + 56:] = -10.0
    rotations[e + 56:] = 0.0
    opacities[e + 56:] = -15.0
    dc[e + 56:] = rest[e + 56:] = 0.0
    raw = {'positions': positions, 'scales': scales, 'rotations': rotations,
           'opacities': opacities, 'features_dc': dc, 'features_rest': rest}
    return {k: torch.tensor(v, dtype=dtype) for k, v in raw.items()}


def _rows_close(got, want, rtol):
    """Each row within ``rtol`` of its largest |want| entry: the formulas
    and autograd sum the same terms in another order."""
    err = (got - want).abs().reshape(got.shape[0], -1)
    scale = want.abs().reshape(want.shape[0], -1).amax(1, keepdim=True)
    return bool((err <= rtol * scale + 1e-300).all())


@pytest.mark.parametrize('low_pass', [0.3, -0.3])
@pytest.mark.parametrize('degree', [1, 2, 3, 4])
def test_gs_frontend_backward_formulas_match_autograd(degree, low_pass):
    """The backward kernel's formulas (``gs_frontend_bwd_plain``, float64)
    against autograd of the plain frontend: each row within 1e-9 of its
    largest entry. Inputs hold every clamp's edge (checked below); the
    depths' gradient is missing (zero) at the negative low pass."""
    rng = np.random.default_rng(10 + degree)
    params = _frontend_params(rng, torch.float64)
    w2c, cam_pos = _camera(torch.float64)
    n = params['positions'].shape[0]
    keys = ['means2d', 'conics', 'colors', 'opacities'] + \
        (['depths'] if low_pass > 0 else [])
    shapes = {'means2d': (n, 2), 'depths': (n,), 'conics': (n, 3),
              'colors': (n, 3), 'opacities': (n,)}
    grads = {k: torch.tensor(rng.normal(size=shapes[k])) for k in keys}
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    out = t_gauss.gs_frontend(leaves, w2c, cam_pos, INTRINSICS, degree,
                              low_pass=low_pass)
    loss = sum((out[k] * grads[k]).sum() for k in keys)
    want = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    got = t_gauss.gs_frontend_bwd_plain(params, w2c, cam_pos, INTRINSICS,
                                        degree, grads, low_pass=low_pass)
    for key in t_gauss.FRONTEND_PARAMS:
        assert got[key].shape == params[key].shape, key
        assert _rows_close(got[key], want[key], 1e-9), key
    # The edges are in the inputs.
    cam = params['positions'] @ w2c[:3, :3].T + w2c[:3, 3]
    u = cam[:, 0] / torch.clamp(cam[:, 2], min=0.01)
    lim_x = 1.3 * 0.5 * INTRINSICS[4] / INTRINSICS[0]
    # conics are (c, -b, a) / max(det, 1e-12): this has det's sign.
    det_sign = out['conics'][:, 0] * out['conics'][:, 2] - \
        out['conics'][:, 1] ** 2
    assert (cam[:, 2] < 0.01).any() and (u.abs() > lim_x).any()
    assert (params['rotations'] == 0).all(-1).any()
    assert (out['colors'] == 0).any() and (out['colors'] > 0).any()
    assert ((params['scales'] < -15) | (params['scales'] > 10)).any()
    assert ((params['scales'] == -15) | (params['scales'] == 10)).any()
    if low_pass < 0:
        assert (det_sign <= 0).any()
        assert not got['features_rest'][:, degree * degree - 1:].any()


def test_gs_frontend_plain_is_the_composition():
    """``gs_frontend`` on the CPU returns the renderer's composition of the
    activations, ``build_covariance_3d``, ``project_gaussians`` and
    ``eval_sh`` bit for bit (f32, 3 of 4 bands)."""
    rng = np.random.default_rng(5)
    params = _frontend_params(rng, torch.float32)
    w2c, cam_pos = _camera(torch.float32)
    got = t_gauss.gs_frontend(params, w2c, cam_pos, INTRINSICS, 3,
                              low_pass=0.3)
    q = params['rotations']
    cov3d = t_gauss.build_covariance_3d(
        torch.exp(torch.clamp(params['scales'], -15.0, 10.0)),
        q * torch.rsqrt(torch.clamp((q * q).sum(-1, keepdim=True),
                                    min=1e-12)))
    proj = t_gauss.project_gaussians(params['positions'], cov3d, w2c,
                                     *INTRINSICS, low_pass=0.3)
    directions = params['positions'] - cam_pos
    directions = directions / torch.clamp(
        torch.linalg.norm(directions, dim=-1, keepdim=True), min=1e-8)
    colors = t_enc.eval_sh(torch.cat([params['features_dc'],
                                      params['features_rest']], dim=1),
                           directions, 3)
    want = {'means2d': proj['means2d'], 'depths': proj['depths'],
            'conics': proj['conics'], 'radii': proj['radii'],
            'colors': torch.clamp(colors + 0.5, min=0.0),
            'opacities': torch.sigmoid(params['opacities'])[:, 0],
            'visible': proj['in_frustum']}
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_gs_frontend_backward_isotropic_rotations_have_no_gradient():
    """Isotropic Gaussians at the identity rotation (as the kNN init makes
    them) have no rotation gradient: autograd of the plain version gives
    exact zeros in f32, and so do the backward's formulas, whose
    covariance gradient is symmetric to the bit (Adam would otherwise
    take a full step on rounding noise)."""
    rng = np.random.default_rng(6)
    params = _frontend_params(rng, torch.float32)
    n = params['positions'].shape[0]
    params['scales'] = params['scales'][:, :1].repeat(1, 3).contiguous()
    params['rotations'] = torch.tensor([[1.0, 0.0, 0.0, 0.0]]).repeat(n, 1)
    w2c, cam_pos = _camera(torch.float32)
    shapes = {'means2d': (n, 2), 'depths': (n,), 'conics': (n, 3),
              'colors': (n, 3), 'opacities': (n,)}
    grads = {k: torch.tensor(rng.normal(size=s), dtype=torch.float32)
             for k, s in shapes.items()}
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    out = t_gauss.gs_frontend(leaves, w2c, cam_pos, INTRINSICS, 4)
    sum((out[k] * grads[k]).sum() for k in grads).backward()
    assert not leaves['rotations'].grad.any()
    got = t_gauss.gs_frontend_bwd_plain(params, w2c, cam_pos, INTRINSICS, 4,
                                        grads)
    assert not got['rotations'].any()
    assert got['scales'].abs().max() > 0
