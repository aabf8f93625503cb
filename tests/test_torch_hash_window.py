"""Parity of the port's windowed hash encode (nerficg_torch/ops/hash_window.py)
with the JAX package's (nerficg_tpu/ops/hash_window.py) on the CPU.

The same numpy inputs go through both; on the CPU the JAX entry point takes
its jnp oracle ``_fwd_jnp`` and the port's wrapper its plain version. Layout,
morton keys and windows must agree exactly (they decide which table entry a
corner reads); encoded features to 1e-6 (f32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.core.errors import KernelError
from nerficg_torch.ops import hash_window as thw
from nerficg_torch.ops.hashgrid import HashGridConfig as TConfig
from nerficg_tpu.ops import hash_window as jhw
from nerficg_tpu.ops.hashgrid import HashGridConfig as JConfig

ATOL_FEATURES = 1e-6

# (levels, log2 table, base, target, anchor stride): the test size and the
# library width (whose layout has dense, shrunk and bricked hash levels).
CONFIGS = [(6, 12, 4, 256, 8), (16, 14, 16, 2048, 8), (8, 14, 16, 512, 1)]


def _configs(args):
    levels, log2, base, target, stride = args
    kw = dict(num_levels=levels, features_per_level=2, log2_table_size=log2,
              base_resolution=base, target_resolution=target,
              anchor_stride=stride)
    return JConfig(**kw), TConfig(**kw)


def _sorted_positions(n, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pos = np.clip(0.5 + v * rng.uniform(0.2, 0.4, (n, 1)), 0.0,
                  1.0 - 1e-6).astype(np.float32)
    keys = np.asarray(jhw.morton_sort_keys(jnp.asarray(pos)))
    return pos[np.argsort(keys, kind='stable')]


def _table(jcfg, seed=1):
    rng = np.random.default_rng(seed)
    rows = jcfg.table_size // 128
    return rng.uniform(-1, 1, (jcfg.num_levels, 2, rows, 128)).astype(
        np.float32)


@pytest.mark.parametrize('args', CONFIGS)
def test_window_layout_matches(args):
    jcfg, tcfg = _configs(args)
    assert tuple(thw.window_layout(tcfg)) == tuple(jhw.window_layout(jcfg))


def test_morton_keys_match():
    rng = np.random.default_rng(0)
    u = rng.uniform(-0.1, 1.1, (3, 4096)).astype(np.float32)
    want = np.asarray(jhw.morton_keys_xyz(*map(jnp.asarray, u)))
    got = thw.morton_keys_xyz(*map(torch.from_numpy, u)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('args', CONFIGS)
@pytest.mark.parametrize('anchored', [False, True])
def test_window_bases_match(args, anchored):
    jcfg, tcfg = _configs(args)
    pos = _sorted_positions(16384)
    anchors = None
    if anchored:
        anchors = np.array(jhw.morton_sort_keys(jnp.asarray(pos)))[::8]
    lo_j, win_j = jhw.window_bases(
        jnp.asarray(pos), jcfg,
        anchor_keys=None if anchors is None else jnp.asarray(anchors))
    lo_t, win_t = thw.window_bases(
        torch.from_numpy(pos), tcfg,
        anchor_keys=None if anchors is None else torch.from_numpy(anchors))
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(win_t.numpy(), np.asarray(win_j))


@pytest.mark.parametrize('args', CONFIGS[:2])
def test_encode_matches_oracle(args):
    """The plain version against ``_fwd_jnp`` on the same windows."""
    jcfg, tcfg = _configs(args)
    pos = _sorted_positions(16384)
    table = _table(jcfg)
    lo, win = jhw.window_bases(jnp.asarray(pos), jcfg)
    want = np.asarray(jhw._fwd_jnp(jnp.asarray(table), jnp.asarray(pos),
                                   jcfg, lo, win))
    got = thw.hash_window_fwd(torch.from_numpy(table), torch.from_numpy(pos),
                              torch.from_numpy(np.array(lo)),
                              torch.from_numpy(np.array(win)), tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_FEATURES)


def test_wrap_rel_matches_at_window_multiples():
    """Exact multiples of the window are where floor(rel * (1/win)) can
    undershoot; both packages must fold them identically."""
    win = np.arange(1, 200, dtype=np.int32)
    rel = (np.arange(-3, 4, dtype=np.int32)[:, None] * win[None]).ravel()
    rel = np.concatenate([rel, rel + 1, rel - 1]).astype(np.int32)
    w = np.tile(win, rel.size // win.size)
    want = np.asarray(jhw._wrap_rel(jnp.asarray(rel), jnp.asarray(w)))
    got = thw._wrap_rel(torch.from_numpy(rel).long(), torch.from_numpy(w).long())
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('n', [8192, 10000])
def test_hash_encode_win_matches(n):
    """Public entry with the marcher's per-block anchor keys, including a
    batch that needs sub-block padding."""
    jcfg, tcfg = _configs(CONFIGS[0])
    pos = _sorted_positions(n, seed=3)
    table = _table(jcfg, seed=4)
    anchors = np.array(jhw.morton_sort_keys(jnp.asarray(pos)))[::8]
    want = np.asarray(jhw.hash_encode_win(
        jnp.asarray(table), jnp.asarray(pos), jcfg, jnp.asarray(anchors)))
    got = thw.hash_encode_win(torch.from_numpy(table), torch.from_numpy(pos),
                              tcfg, torch.from_numpy(anchors))
    assert got.shape == want.shape == (2 * jcfg.num_levels, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_FEATURES)


def test_wrapper_refuses_non_cpu_tensors_without_a_kernel():
    """Off the CPU the wrapper launches its kernel or raises: a tensor that
    is not on a CUDA card (here the meta device) must not reach the plain
    version."""
    _, tcfg = _configs(CONFIGS[0])
    table = torch.empty((6, 2, 32, 128), device='meta')
    pos = torch.empty((8192, 3), device='meta')
    lo = torch.empty((6, 1), dtype=torch.int32, device='meta')
    with pytest.raises(KernelError):
        thw.hash_window_fwd(table, pos, lo, lo, tcfg)
