"""The crossbar encode's position gradient (#12) in the port
(nerficg_torch/ops/hash_xbar.py) against the JAX package on the CPU.

* Exact corners: the plain version and autograd through
  ``hash_encode_xbar_posgrad`` against ``jax.vjp`` of the JAX entry point
  (the oracle ``_dpos_jnp`` on the CPU) and against the TPU kernel
  ``_bwd_pos_pallas`` run in interpret mode, to ATOL_DPOS; the entry
  point's table gradient against JAX's to 1e-5 of its largest entry. The
  gradient scales with the level resolutions (up to 63 here) and sums 8
  corners per level with alternating signs, so it reaches ~300 and an f32
  sum in another order moves it by ~5e-5.
* Stochastic corners (1, 2, 4): the JAX package draws them only on the TPU
  (elsewhere its stochastic posgrad is the exact one), so the port is held
  to its definition instead: the straight-through gradient equals torch
  autograd of the encode rebuilt from the drawn corners' table values and
  per-dim factors, the Bernoulli-sampled dims' factors held constant
  (1e-4 relative to the largest entry; 1 corner: exactly zero).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.core.errors import KernelError
from nerficg_torch.ops import hash_xbar as txb
from nerficg_torch.ops._hash_common import corner_set, exact_dims
from nerficg_torch.ops.hashgrid import HashGridConfig as TConfig
from nerficg_tpu.ops import hash_xbar as jxb
from nerficg_tpu.ops.hashgrid import HashGridConfig as JConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL_DPOS = 1e-4
KW = dict(num_levels=4, features_per_level=2, log2_table_size=11,
          base_resolution=4, target_resolution=64)
JCFG, TCFG = JConfig(**KW), TConfig(**KW)


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1 - 1e-6, (n, 3)).astype(np.float32)
    table = rng.uniform(-1, 1, (4, 2, 16, 128)).astype(np.float32)
    cot = rng.normal(size=(n, 8)).astype(np.float32)
    return pos, table, cot


def test_layout_has_dense_and_hashed_levels():
    _, _, dense, _ = txb.level_layout(TCFG)
    assert 0 < sum(dense) < 4


def test_exact_posgrad_matches_jax_vjp():
    pos, table, cot = _inputs(3000, seed=1)
    _, vjp = jax.vjp(lambda t, p: jxb.hash_encode_xbar_posgrad(t, p, JCFG),
                     jnp.asarray(table), jnp.asarray(pos))
    want_tab, want_pos = (np.asarray(x) for x in vjp(jnp.asarray(cot)))
    got = txb.hash_xbar_bwd_pos(torch.from_numpy(table),
                                torch.from_numpy(pos), torch.from_numpy(cot),
                                TCFG).numpy()
    assert np.abs(want_pos).max() > 50.0
    np.testing.assert_allclose(got, want_pos, rtol=0, atol=ATOL_DPOS)
    t = torch.from_numpy(table).requires_grad_()
    p = torch.from_numpy(pos).requires_grad_()
    out = txb.hash_encode_xbar_posgrad(t, p, TCFG)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), want_pos, rtol=0,
                               atol=ATOL_DPOS)
    np.testing.assert_allclose(t.grad.numpy(), want_tab, rtol=0,
                               atol=1e-5 * np.abs(want_tab).max())


def test_exact_posgrad_matches_interpret_kernel():
    """The TPU kernel ``_bwd_pos_pallas`` in interpret mode (pallas_call
    patched as tests/test_hash_xbar.py patches it), exact corners."""
    pos, table, cot = _inputs(300, seed=2)
    orig = jxb.pl.pallas_call

    def call(*a, **kw):
        kw['interpret'] = True
        kw.pop('compiler_params', None)
        return orig(*a, **kw)
    with mock.patch.object(jxb.pl, 'pallas_call', call):
        want = np.asarray(jxb._bwd_pos_pallas(
            jnp.asarray(table), jnp.asarray(pos), jnp.asarray(cot), JCFG,
            None, 0))
    got = txb.hash_xbar_bwd_pos_plain(torch.from_numpy(table),
                                      torch.from_numpy(pos),
                                      torch.from_numpy(cot), TCFG).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_DPOS)


def _straight_through_reference(table, pos, cot, n_corners, seed):
    """d/d(unit) of sum(cot * encode) by torch autograd, with each level's
    encode rebuilt as sum_c v_c prod_d factor_{c,d}(frac): the drawn
    corners' bf16 values and their interpolated dims' lerp factors, the
    sampled dims' factor a constant 1."""
    p = pos.clone().requires_grad_()
    flat = table.reshape(4, 2, -1).to(torch.bfloat16).float()
    res_m1 = txb.level_layout(TCFG)[0]
    total = 0.0
    for lv in range(4):
        with torch.no_grad():
            verts, _ = corner_set(pos, int(res_m1[lv]) + 1, lv, n_corners,
                                  seed)
            vals = flat[lv][:, txb._flat_index(verts, TCFG, lv)]
            base = torch.floor(pos * res_m1[lv])
            upper = (verts - base[:, None, :].long()) == 1
        scaled = p * res_m1[lv]
        frac = scaled - base
        exact = torch.stack(exact_dims(tuple(frac.detach().unbind(-1)),
                                       n_corners), -1)[:, None, :]
        f = frac[:, None, :]
        factors = torch.where(exact, torch.where(upper, f, 1.0 - f),
                              torch.ones_like(f))
        w = factors.prod(-1)                                     # (N, C)
        enc = (vals * w[None]).sum(-1)                           # (2, N)
        total = total + (enc * cot[:, 2 * lv:2 * lv + 2].T).sum()
    total.backward()
    return p.grad


@pytest.mark.parametrize('n_corners', [1, 2, 4])
def test_stochastic_posgrad_is_straight_through(n_corners):
    pos, table, cot = _inputs(2000, seed=3)
    pos_t, table_t, cot_t = (torch.from_numpy(x) for x in (pos, table, cot))
    want = _straight_through_reference(table_t, pos_t, cot_t, n_corners,
                                       0xBEEF)
    p = pos_t.clone().requires_grad_()
    out = txb.hash_encode_xbar_stochastic_posgrad(table_t, p, 0xBEEF, TCFG,
                                                  n_corners)
    (out * cot_t).sum().backward()
    got = p.grad
    np.testing.assert_array_equal(
        got.numpy(), txb.hash_xbar_bwd_pos(table_t, pos_t, cot_t, TCFG,
                                           n_corners, 0xBEEF).numpy())
    if n_corners == 1:
        assert not got.any()           # every dim sampled: no path gradient
        return
    scale = float(want.abs().max())
    assert scale > 10.0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-4 * scale)
    other = txb.hash_xbar_bwd_pos(table_t, pos_t, cot_t, TCFG, n_corners,
                                  0xBEF0)
    assert not torch.equal(other, got)        # the seed matters


def test_position_gradient_only_when_needed():
    """The entry point launches no position gradient for positions that do
    not need one, and no table gradient for a frozen table."""
    pos, table, cot = _inputs(500, seed=4)
    t = torch.from_numpy(table).requires_grad_()
    out = txb.hash_encode_xbar_posgrad(t, torch.from_numpy(pos), TCFG)
    (out * torch.from_numpy(cot)).sum().backward()
    assert t.grad is not None
    p = torch.from_numpy(pos).requires_grad_()
    out = txb.hash_encode_xbar_posgrad(torch.from_numpy(table), p, TCFG)
    (out * torch.from_numpy(cot)).sum().backward()
    assert p.grad is not None and p.grad.abs().max() > 0


def test_wrapper_refuses_non_cpu_tensors_without_a_kernel():
    table = torch.empty((4, 2, 16, 128), device='meta')
    pos = torch.empty((100, 3), device='meta')
    g = torch.empty((100, 8), device='meta')
    for n_corners in (0, 2):
        with pytest.raises(KernelError):
            txb.hash_xbar_bwd_pos(table, pos, g, TCFG, n_corners, 1)
