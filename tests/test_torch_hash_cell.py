"""Parity of the port's cell-packed hash encode (nerficg_torch/ops/hash_cell.py)
with the JAX package's (nerficg_tpu/ops/hash_cell.py) on the CPU.

The same numpy inputs go through both; on the CPU the JAX entry point takes
its jnp oracles ``_fwd_jnp`` / ``_bwd_jnp`` and the port's wrappers their
plain versions. Layouts and windows must agree exactly (they decide which
table entry a corner reads), at the test size and at the library's and the
reference's table sizes (2^14, 2^19). Encoded features agree to atol 1e-5
(f32 sums in another order), table gradients to 1e-5 of the largest entry
(scatter sums in another order; the coarse levels sum thousands of
products into one entry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.core.errors import KernelError
from nerficg_torch.ops import hash_cell as thc
from nerficg_torch.ops import hash_window as thw
from nerficg_torch.ops.hashgrid import HashGridConfig as TConfig
from nerficg_tpu.ops import hash_cell as jhc
from nerficg_tpu.ops.hashgrid import HashGridConfig as JConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL_FEATURES = 1e-5
GRAD_ATOL_OF_MAX = 1e-5

# (levels, log2 table, base, target, anchor stride). The test size has dense,
# mid (b = 0, shrunk table) and bricked hash levels with rsh > 0; the other
# two are the library width and the reference's 2^19 (layouts and windows
# only: the encode at 2^19 is the card's job).
SMALL = (6, 12, 4, 256, 8)
LAYOUT_CONFIGS = [SMALL, (8, 14, 16, 512, 1), (16, 14, 16, 2048, 8),
                  (16, 19, 16, 2048, 8)]


def _configs(args):
    levels, log2, base, target, stride = args
    kw = dict(num_levels=levels, features_per_level=2, log2_table_size=log2,
              base_resolution=base, target_resolution=target,
              anchor_stride=stride)
    return JConfig(**kw), TConfig(**kw)


def _positions(n, seed=0, sort=True):
    """Samples on a spherical shell, morton-sorted unless ``sort`` is off."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pos = np.clip(0.5 + v * rng.uniform(0.2, 0.4, (n, 1)), 0.0,
                  1.0 - 1e-6).astype(np.float32)
    if not sort:
        return pos
    keys = thw.morton_sort_keys(torch.from_numpy(pos)).numpy()
    return pos[np.argsort(keys, kind='stable')]


def _table(jcfg, seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (jcfg.num_levels, 2, jcfg.table_size // 128,
                               128)).astype(np.float32)


def _anchors(pos, stride=8):
    return thw.morton_sort_keys(torch.from_numpy(pos)).numpy()[::stride].copy()


def _assert_grad_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GRAD_ATOL_OF_MAX * np.abs(want).max())


@pytest.mark.parametrize('args', LAYOUT_CONFIGS)
def test_cell_layout_matches(args):
    jcfg, tcfg = _configs(args)
    assert tuple(thc.cell_layout(tcfg)) == tuple(jhc.cell_layout(jcfg))


def test_small_layout_has_every_kind_of_level():
    lay = thc.cell_layout(_configs(SMALL)[1])
    assert lay.dense[:2] == (1, 1)
    hashed = [lv for lv in range(6) if not lay.dense[lv]]
    assert any(lay.bscale[lv] * (lay.res[lv] - 1) == 1.0 for lv in hashed)
    assert any(lay.rsh[lv] > 0 for lv in hashed)


@pytest.mark.parametrize('args', LAYOUT_CONFIGS)
@pytest.mark.parametrize('anchored', [False, True])
def test_cell_window_bases_match(args, anchored):
    jcfg, tcfg = _configs(args)
    pos = _positions(8192)
    anchors = _anchors(pos) if anchored else None
    lo_j, win_j = jhc.cell_window_bases(
        jnp.asarray(pos), jcfg,
        anchor_keys=None if anchors is None else jnp.asarray(anchors))
    lo_t, win_t = thc.cell_window_bases(
        torch.from_numpy(pos), tcfg,
        anchor_keys=None if anchors is None else torch.from_numpy(anchors))
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(win_t.numpy(), np.asarray(win_j))
    lay = thc.cell_layout(tcfg)
    hi = lo_t.long() + win_t.long()
    assert (win_t >= 1).all()
    assert all((hi[lv] <= lay.base_rows[lv]).all() for lv in range(len(hi)))


@pytest.mark.parametrize('sort', [True, False])
def test_encode_matches_oracle(sort):
    """The plain version against ``_fwd_jnp`` on the same windows, for
    morton-sorted and unsorted samples (wide windows)."""
    jcfg, tcfg = _configs(SMALL)
    pos = _positions(8192, sort=sort)
    table = _table(jcfg)
    lo, win = jhc.cell_window_bases(jnp.asarray(pos), jcfg)
    want = np.asarray(jhc._fwd_jnp(jnp.asarray(table), jnp.asarray(pos),
                                   jcfg, lo, win))
    got = thc.hash_cell_fwd(torch.from_numpy(table), torch.from_numpy(pos),
                            torch.from_numpy(np.array(lo)),
                            torch.from_numpy(np.array(win)), tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_FEATURES)


@pytest.mark.parametrize('n, sort', [(8192, True), (5000, True),
                                     (5000, False)])
def test_hash_encode_cell_matches(n, sort):
    """Public entry with the marcher's per-block anchor keys (sorted) or
    without (unsorted), including a batch that needs sub-block padding."""
    jcfg, tcfg = _configs(SMALL)
    pos = _positions(n, seed=3, sort=sort)
    table = _table(jcfg, seed=4)
    anchors = _anchors(pos) if sort else None
    want = np.asarray(jhc.hash_encode_cell(
        jnp.asarray(table), jnp.asarray(pos), jcfg,
        None if anchors is None else jnp.asarray(anchors)))
    got = thc.hash_encode_cell(
        torch.from_numpy(table), torch.from_numpy(pos), tcfg,
        None if anchors is None else torch.from_numpy(anchors))
    assert got.shape == want.shape == (2 * jcfg.num_levels, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_FEATURES)


def test_bwd_matches_oracle():
    """``hash_cell_bwd`` (plain) against ``_bwd_jnp`` on the same windows."""
    jcfg, tcfg = _configs(SMALL)
    pos = _positions(8192, seed=5)
    lo, win = jhc.cell_window_bases(jnp.asarray(pos), jcfg)
    g = np.random.default_rng(6).normal(
        size=(2 * jcfg.num_levels, 8192)).astype(np.float32)
    rows = jcfg.table_size // 128
    shape = (jcfg.num_levels, 2, rows, 128)
    want = np.asarray(jhc._bwd_jnp(shape, jnp.asarray(pos), jnp.asarray(g),
                                   jcfg, lo, win))
    got = thc.hash_cell_bwd(torch.from_numpy(g), torch.from_numpy(pos),
                            torch.from_numpy(np.array(lo)),
                            torch.from_numpy(np.array(win)), tcfg, rows)
    _assert_grad_close(got.numpy(), want)


@pytest.mark.parametrize('sort', [True, False])
def test_encode_grad_matches_jax(sort):
    """torch.autograd through the port's hash_encode_cell against jax.grad
    through the JAX one, on a padded batch."""
    jcfg, tcfg = _configs(SMALL)
    n = 5000
    pos = _positions(n, seed=7, sort=sort)
    table = _table(jcfg, seed=8)
    anchors = _anchors(pos) if sort else None
    cot = np.random.default_rng(9).normal(
        size=(2 * jcfg.num_levels, n)).astype(np.float32)

    def loss(t):
        out = jhc.hash_encode_cell(
            t, jnp.asarray(pos), jcfg,
            None if anchors is None else jnp.asarray(anchors))
        return jnp.sum(out * cot)

    want = np.asarray(jax.grad(loss)(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_()
    out = thc.hash_encode_cell(
        t, torch.from_numpy(pos), tcfg,
        None if anchors is None else torch.from_numpy(anchors))
    (out * torch.from_numpy(cot)).sum().backward()
    _assert_grad_close(t.grad.numpy(), want)


def test_wrappers_refuse_non_cpu_tensors_without_a_kernel():
    """Off the CPU both wrappers launch their kernel or raise: a tensor on
    the meta device must not reach the plain version."""
    _, tcfg = _configs(SMALL)
    table = torch.empty((6, 2, 32, 128), device='meta')
    pos = torch.empty((2048, 3), device='meta')
    lo = torch.empty((6, 1), dtype=torch.int32, device='meta')
    g = torch.empty((12, 2048), device='meta')
    for call in (lambda: thc.hash_cell_fwd(table, pos, lo, lo, tcfg),
                 lambda: thc.hash_cell_bwd(g, pos, lo, lo, tcfg, 32)):
        with pytest.raises(KernelError):
            call()
