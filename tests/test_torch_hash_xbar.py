"""Parity of the port's crossbar hash encode (nerficg_torch/ops/hash_xbar.py)
with the JAX package's (nerficg_tpu/ops/hash_xbar.py) on the CPU.

* Exact corners: the layout equals JAX's ``level_layout`` (also at the
  reference's 2^19); features agree with ``hash_encode_xbar`` (the jnp oracle
  on the CPU) to atol 1e-5 and table gradients with ``jax.grad`` to 1e-5 of
  the largest entry (sums in another order).
* Stochastic corners: the JAX package has them only on the TPU (its CPU path
  returns the exact encode), and the port draws its own (counter hash), so
  they are held to what they must be instead: unbiased (the mean over 512
  seeds within 5 standard errors of the exact encode), and differentiated
  on the corners they drew (the table gradient equals an index_add of
  g * w at exactly those corners, to rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.core.errors import KernelError
from nerficg_torch.ops import hash_xbar as txb
from nerficg_torch.ops.hashgrid import HashGridConfig as TConfig
from nerficg_tpu.ops import hash_xbar as jxb
from nerficg_tpu.ops.hashgrid import HashGridConfig as JConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL_FEATURES = 1e-5
GRAD_ATOL_OF_MAX = 1e-5

# (levels, log2 table, base, target): dense and hashed levels at 2^12 and
# 2^14; the library width and the reference's 2^19 for the layout.
SMALL = (6, 12, 4, 256)
CONFIGS = [SMALL, (8, 14, 16, 512), (16, 14, 16, 2048), (16, 19, 16, 2048)]


def _configs(args):
    levels, log2, base, target = args
    kw = dict(num_levels=levels, features_per_level=2, log2_table_size=log2,
              base_resolution=base, target_resolution=target)
    return JConfig(**kw), TConfig(**kw)


def _inputs(jcfg, n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1 - 1e-6, (n, 3)).astype(np.float32)
    table = rng.uniform(-1, 1, (jcfg.num_levels, 2, jcfg.table_size // 128,
                                128)).astype(np.float32)
    cot = rng.normal(size=(n, 2 * jcfg.num_levels)).astype(np.float32)
    return pos, table, cot


@pytest.mark.parametrize('args', CONFIGS)
def test_level_layout_matches(args):
    jcfg, tcfg = _configs(args)
    assert txb.level_layout(tcfg) == jxb.level_layout(jcfg)
    assert 0 < sum(txb.level_layout(tcfg)[2]) < jcfg.num_levels


@pytest.mark.parametrize('args', CONFIGS[:2])
def test_exact_encode_and_grad_match_jax(args):
    """5000 samples (not a multiple of any tile), sample-major output."""
    jcfg, tcfg = _configs(args)
    pos, table, cot = _inputs(jcfg, 5000, seed=1)

    def loss(t):
        return jnp.sum(jxb.hash_encode_xbar(t, jnp.asarray(pos), jcfg) * cot)

    want = np.asarray(jxb.hash_encode_xbar(jnp.asarray(table),
                                           jnp.asarray(pos), jcfg))
    want_grad = np.asarray(jax.grad(loss)(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_()
    out = txb.hash_encode_xbar(t, torch.from_numpy(pos), tcfg)
    assert out.shape == want.shape == (5000, 2 * jcfg.num_levels)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                               atol=ATOL_FEATURES)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(
        t.grad.numpy(), want_grad, rtol=0,
        atol=GRAD_ATOL_OF_MAX * np.abs(want_grad).max())


def test_plain_versions_match_the_oracles():
    """The plain forward and gradient against ``_fwd_jnp`` / ``_bwd_jnp``."""
    jcfg, tcfg = _configs(SMALL)
    pos, table, cot = _inputs(jcfg, 4096, seed=2)
    shape = table.shape
    want = np.asarray(jxb._fwd_jnp(jnp.asarray(table), jnp.asarray(pos),
                                   jcfg))
    got = txb.hash_xbar_fwd(torch.from_numpy(table), torch.from_numpy(pos),
                            tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_FEATURES)
    want = np.asarray(jxb._bwd_jnp(shape, jnp.asarray(pos), jnp.asarray(cot),
                                   jcfg))
    got = txb.hash_xbar_bwd(torch.from_numpy(cot), torch.from_numpy(pos),
                            tcfg, shape[2])
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=GRAD_ATOL_OF_MAX * np.abs(want).max())


@pytest.mark.parametrize('n_corners', [1, 2, 4])
def test_stochastic_grad_lands_on_the_drawn_corners(n_corners):
    """Autograd through hash_encode_xbar_stochastic: the forward is the
    weighted bf16 gather of the corners ``xbar_corners`` draws for that
    seed, and the table gradient is g * w added at exactly those corners."""
    jcfg, tcfg = _configs(SMALL)
    pos, table, cot = _inputs(jcfg, 3000, seed=3)
    pos_t, cot_t = torch.from_numpy(pos), torch.from_numpy(cot)
    t = torch.from_numpy(table).requires_grad_()
    out = txb.hash_encode_xbar_stochastic(t, pos_t, 0xC0FFEE, tcfg,
                                          n_corners)
    (out * cot_t).sum().backward()
    flat = torch.from_numpy(table).reshape(jcfg.num_levels, 2, -1)
    flat = flat.to(torch.bfloat16).float()
    want = torch.zeros_like(flat)
    for lv in range(jcfg.num_levels):
        idx, w = txb.xbar_corners(pos_t, tcfg, lv, n_corners, 0xC0FFEE)
        assert idx.shape == w.shape == (3000, n_corners)
        feats = (flat[lv][:, idx] * w[None]).sum(-1)
        np.testing.assert_allclose(out[:, 2 * lv:2 * lv + 2].detach().numpy(),
                                   feats.T.numpy(), rtol=0, atol=1e-6)
        for f in range(2):
            want[lv, f].index_add_(0, idx.reshape(-1),
                                   (cot_t[:, 2 * lv + f, None] * w).reshape(-1))
    np.testing.assert_allclose(t.grad.reshape(want.shape).numpy(),
                               want.numpy(), rtol=1e-6, atol=1e-6)
    other = txb.hash_encode_xbar_stochastic(t.detach(), pos_t, 0xC0FFEF, tcfg,
                                            n_corners)
    assert not torch.equal(other, out.detach())   # the seed matters


@pytest.mark.parametrize('n_corners', [1, 2, 4])
def test_stochastic_encode_is_unbiased(n_corners):
    """Mean over 512 seeds of the stochastic plain encode against the exact
    encode: |mean - exact| <= 5 standard errors of the mean (the seeds'
    sample standard deviation / sqrt(511)), +1e-6 for f32 rounding, for
    >= 99.9% of the elements. Every level's fractions stay in [0.05, 0.95],
    so each draw has probability >= 0.05 and 512 seeds see both outcomes
    (as tests/test_torch_stochastic_corners.py does for the window)."""
    cfg = TConfig(num_levels=4, features_per_level=2, log2_table_size=12,
                  base_resolution=4, target_resolution=64)
    rng = np.random.default_rng(21)
    cand = rng.uniform(0, 1, (40000, 3)).astype(np.float32)
    keep = np.ones(len(cand), bool)
    for res in cfg.level_resolutions():
        scaled = cand * np.float32(res - 1)
        frac = scaled - np.floor(scaled)
        keep &= ((frac >= 0.05) & (frac <= 0.95)).all(1)
    assert keep.sum() >= 4096
    pos = torch.from_numpy(cand[keep][:4096])
    table = torch.from_numpy(rng.uniform(-1, 1, (4, 2, 32, 128)).astype(
        np.float32))
    exact = txb.hash_xbar_fwd(table, pos, cfg).double()
    seeds = 512
    total = torch.zeros_like(exact)
    total_sq = torch.zeros_like(exact)
    for seed in range(seeds):
        out = txb.hash_xbar_fwd(table, pos, cfg, n_corners,
                                seed * 7919 + 1).double()
        total += out
        total_sq += out * out
    mean = total / seeds
    var = torch.clamp(total_sq / seeds - mean * mean, min=0.0)
    stderr = torch.sqrt(var / (seeds - 1))
    within = (mean - exact).abs() <= 5.0 * stderr + 1e-6
    assert float(within.double().mean()) >= 0.999


def test_wrappers_refuse_non_cpu_tensors_without_a_kernel():
    """Off the CPU both wrappers launch their kernel or raise: a tensor on
    the meta device must not reach the plain version."""
    _, tcfg = _configs(SMALL)
    table = torch.empty((6, 2, 32, 128), device='meta')
    pos = torch.empty((100, 3), device='meta')
    g = torch.empty((100, 12), device='meta')
    for call in (lambda: txb.hash_xbar_fwd(table, pos, tcfg),
                 lambda: txb.hash_xbar_fwd(table, pos, tcfg, 4, 1),
                 lambda: txb.hash_xbar_bwd(g, pos, tcfg, 32),
                 lambda: txb.hash_xbar_bwd(g, pos, tcfg, 32, 2, 1)):
        with pytest.raises(KernelError):
            call()
