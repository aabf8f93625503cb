"""Gradients of the port's differentiable pieces against jax.grad of the JAX
package's, on the CPU: the segment gather / scatter-add Functions
(ops/hash_mxu.py gather_d, scatter_add_d), the block permutation
(ops/sample_sort.py), the density activation ``trunc_exp``, and the
learning-rate schedule. Tolerances: 1e-6 for the gathers and permutations
(the same values moved), 1e-5 relative for the scatter sums (another
order), exact for trunc_exp's gradient to f32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.methods.instant_ngp.model import trunc_exp
from nerficg_torch.ops import hash_mxu as tmxu
from nerficg_torch.ops import sample_sort as tsort
from nerficg_torch.optim.lr import multistep_lr
from nerficg_torch.optim.metrics import mse_to_psnr
from nerficg_tpu.methods.instant_ngp import model as jmodel
from nerficg_tpu.ops import hash_mxu as jmxu
from nerficg_tpu.ops import sample_sort as jsort
from nerficg_tpu.optim import lr as jlr
from nerficg_tpu.optim import metrics as jmetrics
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _segments(seed=0, m=3000, rows=4):
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.integers(0, rows * 128, (1, m))).astype(np.int32)
    return rng, idx, rows


def test_gather_d_grad_matches():
    rng, idx, rows = _segments()
    table = rng.normal(size=(1, 2, rows, 128)).astype(np.float32)
    cot = rng.normal(size=(1, 2, idx.shape[1])).astype(np.float32)
    want_out = np.asarray(jmxu.gather_d(jnp.asarray(idx), jnp.asarray(table)))
    want = np.asarray(jax.grad(lambda t: jnp.sum(
        jmxu.gather_d(jnp.asarray(idx), t) * cot))(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_()
    out = tmxu.gather_d(torch.from_numpy(idx), t)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-5, atol=1e-6)


def test_scatter_add_d_grad_matches():
    rng, idx, rows = _segments(seed=1)
    g = rng.normal(size=(1, 5, idx.shape[1])).astype(np.float32)
    cot = rng.normal(size=(1, 5, rows, 128)).astype(np.float32)
    want_out = np.asarray(jmxu.scatter_add_d(jnp.asarray(idx),
                                             jnp.asarray(g), rows))
    want = np.asarray(jax.grad(lambda v: jnp.sum(
        jmxu.scatter_add_d(jnp.asarray(idx), v, rows) * cot))(
            jnp.asarray(g)))
    v = torch.from_numpy(g).requires_grad_()
    out = tmxu.scatter_add_d(torch.from_numpy(idx), v, rows)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(v.grad.numpy(), want, rtol=0, atol=1e-6)


def test_permute_block_channels_grad_matches():
    """Output and gradient (a gather through the inverse permutation in
    both packages) against the JAX VJP."""
    rng = np.random.default_rng(2)
    block, nb = 8, 96
    perm = rng.permutation(nb).astype(np.int32)
    perm_inv = np.argsort(perm).astype(np.int32)
    ch = rng.normal(size=(4, nb * block)).astype(np.float32)
    cot = rng.normal(size=(4, nb * block)).astype(np.float32)

    def f(c):
        return jsort.permute_block_channels(c, block, jnp.asarray(perm),
                                            jnp.asarray(perm_inv))
    want_out = np.asarray(f(jnp.asarray(ch)))
    want = np.asarray(jax.grad(lambda c: jnp.sum(f(c) * cot))(
        jnp.asarray(ch)))
    c = torch.from_numpy(ch).requires_grad_()
    out = tsort.permute_block_channels(c, block, torch.from_numpy(perm).long(),
                                       torch.from_numpy(perm_inv).long())
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), want_out)
    np.testing.assert_array_equal(c.grad.numpy(), want)


def test_trunc_exp_grad_matches_jax():
    """d/dx trunc_exp = exp(clip(x, -15, 15)) everywhere, as the JAX
    custom_jvp says; autograd of a clamp would give 0 beyond +-15."""
    x = np.array([-20.0, -15.0, 0.0, 15.0, 20.0], np.float32)
    want_y = np.asarray(jmodel.trunc_exp(jnp.asarray(x)))
    want = np.asarray(jax.vmap(jax.grad(jmodel.trunc_exp))(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_()
    y = trunc_exp(t)
    (grad,) = torch.autograd.grad(y.sum(), t)
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), want, rtol=1e-6)
    assert grad[0] > 0 and grad[-1] > 0


def test_multistep_lr_and_psnr_match():
    milestones = [20, 30, 40]
    sched_j = jlr.multistep_lr(1e-2, milestones, 0.33)
    sched_t = multistep_lr(1e-2, milestones, 0.33)
    for step in (0, 19, 20, 29, 30, 45):
        assert sched_t(step) == pytest.approx(float(sched_j(step)),
                                              rel=1e-6)
    for mse in (0.0, 1e-3, 0.25):
        assert float(mse_to_psnr(torch.tensor(mse))) == pytest.approx(
            float(jmetrics.mse_to_psnr(jnp.asarray(mse))), rel=1e-6)
