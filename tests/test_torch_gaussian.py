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
