"""The crossbar backward's fused entry (nerficg_torch/ops/hash_xbar.py
``hash_xbar_bwd_fused``, kernels #11 and #12 from one call) on the CPU,
where it takes its plain version, against the two plain versions it
replaces and the JAX package's oracles.

* (a) The fused plain version equals ``hash_xbar_bwd_plain`` and
  ``hash_xbar_bwd_pos_plain`` bit for bit, exact and at 1/2/4 corners, and
  agrees with ``_bwd_jnp`` and ``_dpos_jnp`` (exact corners) within the
  tolerances of tests/test_torch_hash_xbar.py (table gradient 1e-5 of its
  largest entry) and tests/test_torch_hash_xbar_pos.py (ATOL_DPOS).
* (b) Per-level partials with the skipped (sample, level) pairs as exact
  zeros, added in level order, equal the plain position gradient bit for
  bit: the level-resident kernel writes those partials to scratch and sums
  them so.
* (c) The launch plan is a function of the shapes: the resident path at
  2^12 and 2^14 entries within a block's 232,448 bytes of shared memory,
  the gather path at 2^15 and 2^19.
* (d) ``hash_encode_xbar_posgrad``'s backward calls the fused entry once
  and gives the two plain versions' gradients; through a frozen table it
  calls the position gradient's own wrapper once instead.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.ops import hash_xbar as txb
from nerficg_torch.ops.hashgrid import HashGridConfig as TConfig
from nerficg_tpu.ops import hash_xbar as jxb
from nerficg_tpu.ops.hashgrid import HashGridConfig as JConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL_DPOS = 1e-4
GRAD_ATOL_OF_MAX = 1e-5
KW = dict(num_levels=4, features_per_level=2, log2_table_size=11,
          base_resolution=4, target_resolution=64)
JCFG, TCFG = JConfig(**KW), TConfig(**KW)


def _inputs(n, seed, zero_share=0.25):
    """Positions in [0, 1), a (4, 2, 16, 128) table and a cotangent with
    ``zero_share`` of its (sample, level) pairs zero in both features."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1 - 1e-6, (n, 3)).astype(np.float32)
    table = rng.uniform(-1, 1, (4, 2, 16, 128)).astype(np.float32)
    cot = rng.normal(size=(n, 8)).astype(np.float32)
    keep = rng.random((n, 4)) >= zero_share
    cot *= np.repeat(keep, 2, axis=1)
    return pos, table, cot


@pytest.mark.parametrize('n_corners', [0, 1, 2, 4])
def test_fused_plain_equals_the_two_plain_versions(n_corners):
    pos, table, cot = (torch.from_numpy(x) for x in _inputs(2000, seed=1))
    dtab, dpos = txb.hash_xbar_bwd_fused(table, pos, cot, TCFG, n_corners,
                                         0xABCD)
    assert torch.equal(dtab, txb.hash_xbar_bwd_plain(cot, pos, TCFG, 16,
                                                     n_corners, 0xABCD))
    assert torch.equal(dpos, txb.hash_xbar_bwd_pos_plain(
        table, pos, cot, TCFG, n_corners, 0xABCD))
    if n_corners != 1:
        assert float(dpos.abs().max()) > 1.0


def test_fused_plain_matches_the_jax_oracles():
    pos, table, cot = _inputs(3000, seed=2)
    dtab, dpos = txb.hash_xbar_bwd_fused(torch.from_numpy(table),
                                         torch.from_numpy(pos),
                                         torch.from_numpy(cot), TCFG)
    want_tab = np.asarray(jxb._bwd_jnp(table.shape, jnp.asarray(pos),
                                       jnp.asarray(cot), JCFG))
    want_pos = np.asarray(jxb._dpos_jnp(jnp.asarray(table), jnp.asarray(pos),
                                        jnp.asarray(cot), JCFG))
    np.testing.assert_allclose(dtab.numpy(), want_tab, rtol=0,
                               atol=GRAD_ATOL_OF_MAX * np.abs(want_tab).max())
    assert np.abs(want_pos).max() > 50.0
    np.testing.assert_allclose(dpos.numpy(), want_pos, rtol=0,
                               atol=ATOL_DPOS)


@pytest.mark.parametrize('n_corners', [0, 2, 4])
@pytest.mark.parametrize('zero_share', [0.0, 0.5])
def test_level_partials_sum_to_the_plain_position_gradient(n_corners,
                                                           zero_share):
    pos, table, cot = (torch.from_numpy(x) for x in _inputs(
        1500, seed=3, zero_share=zero_share))
    # (L, N, 3) as the level-resident kernel writes its scratch: each
    # level's sum, exact zeros where the (sample, level) is skipped.
    skipped = (cot.reshape(1500, 4, 2) == 0).all(-1).T
    parts = torch.stack(list(txb._dpos_levels(table, pos, cot, TCFG,
                                              n_corners, 77)))
    parts = torch.where(skipped[..., None], torch.zeros_like(parts), parts)
    assert parts.shape == (4, 1500, 3)
    assert bool(skipped.any()) == (zero_share > 0)
    assert not parts[skipped].any()
    total = torch.zeros_like(pos)
    for part in parts:                  # the kernel's order: level 0 first
        total = total + part
    want = txb.hash_xbar_bwd_pos_plain(table, pos, cot, TCFG, n_corners, 77)
    assert torch.equal(total.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize('log2, path', [(12, 'resident'), (14, 'resident'),
                                        (15, 'gather'), (19, 'gather')])
def test_launch_plan_follows_the_shapes(log2, path):
    cfg = TConfig(num_levels=16, features_per_level=2, log2_table_size=log2,
                  base_resolution=16, target_resolution=2048)
    plan = txb.xbar_bwd_plan(cfg, 262144)
    assert plan.path == path
    assert plan.level_rows == (1 << log2) // 128
    if path == 'resident':
        assert 0 < plan.smem_bytes <= 232_448
        assert plan.smem_bytes == plan.level_rows * 128 * 12
        assert plan.tiles == 132 // 16
        # Either gradient alone asks for less.
        assert txb.xbar_bwd_plan(cfg, 262144, pos=False).smem_bytes == \
            plan.level_rows * 128 * 8
        assert txb.xbar_bwd_plan(cfg, 262144, tab=False).smem_bytes == \
            plan.level_rows * 128 * 4
    else:
        assert plan.tiles == 0 and plan.smem_bytes == 0
    # Few samples: no more tiles than blocks of RESIDENT_THREADS samples.
    assert txb.xbar_bwd_plan(cfg, 1500).tiles == (2 if path == 'resident'
                                                  else 0)


@pytest.mark.parametrize('n_corners', [0, 4])
def test_posgrad_backward_takes_the_fused_entry_once(n_corners):
    pos, table, cot = (torch.from_numpy(x) for x in _inputs(1000, seed=4))
    t = table.clone().requires_grad_()
    p = pos.clone().requires_grad_()
    with mock.patch.object(txb, 'hash_xbar_bwd_fused',
                           wraps=txb.hash_xbar_bwd_fused) as fused, \
            mock.patch.object(txb, 'hash_xbar_bwd',
                              wraps=txb.hash_xbar_bwd) as tab_only, \
            mock.patch.object(txb, 'hash_xbar_bwd_pos',
                              wraps=txb.hash_xbar_bwd_pos) as pos_only:
        if n_corners:
            out = txb.hash_encode_xbar_stochastic_posgrad(t, p, 9, TCFG,
                                                          n_corners)
        else:
            out = txb.hash_encode_xbar_posgrad(t, p, TCFG)
        (out * cot).sum().backward()
    assert fused.call_count == 1
    assert tab_only.call_count == 0 and pos_only.call_count == 0
    seed = 9 if n_corners else 0
    assert torch.equal(t.grad, txb.hash_xbar_bwd_plain(cot, pos, TCFG, 16,
                                                       n_corners, seed))
    assert torch.equal(p.grad, txb.hash_xbar_bwd_pos_plain(
        table, pos, cot, TCFG, n_corners, seed))


def test_frozen_table_backward_takes_the_position_wrapper():
    pos, table, cot = (torch.from_numpy(x) for x in _inputs(1000, seed=5))
    p = pos.clone().requires_grad_()
    with mock.patch.object(txb, 'hash_xbar_bwd_fused',
                           wraps=txb.hash_xbar_bwd_fused) as fused, \
            mock.patch.object(txb, 'hash_xbar_bwd_pos',
                              wraps=txb.hash_xbar_bwd_pos) as pos_only:
        (txb.hash_encode_xbar_posgrad(table, p, TCFG) * cot).sum().backward()
    assert fused.call_count == 0 and pos_only.call_count == 1
    assert torch.equal(p.grad, txb.hash_xbar_bwd_pos_plain(table, pos, cot,
                                                           TCFG))
