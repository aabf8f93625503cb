"""Parity of the port's windowed hash encode (nerficg_torch/ops/hash_window.py)
with the JAX package's (nerficg_tpu/ops/hash_window.py) on the CPU.

The same numpy inputs go through both; on the CPU the JAX entry point takes
its jnp oracles ``_fwd_jnp`` / ``_bwd_jnp`` and the port's wrappers their
plain versions. Layout, morton keys and windows must agree exactly (they
decide which table entry a corner reads); encoded features to 1e-6 (f32 sums
in another order); table gradients to rtol 1e-5, atol 1e-6 (scatter sums
taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.core.errors import KernelError
from nerficg_torch.ops import _hash_common as tcommon
from nerficg_torch.ops import hash_window as thw
from nerficg_torch.ops.hashgrid import HashGridConfig as TConfig
from nerficg_tpu.ops import hash_window as jhw
from nerficg_tpu.ops.hashgrid import HashGridConfig as JConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL_FEATURES = 1e-6
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)

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
    got = tcommon.wrap_rel(torch.from_numpy(rel).long(),
                          torch.from_numpy(w).long())
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
    """Off the CPU every wrapper launches its kernel or raises: a tensor that
    is not on a CUDA card (here the meta device) must not reach the plain
    version."""
    _, tcfg = _configs(CONFIGS[0])
    table = torch.empty((6, 2, 32, 128), device='meta')
    pos = torch.empty((8192, 3), device='meta')
    lo = torch.empty((6, 1), dtype=torch.int32, device='meta')
    g = torch.empty((12, 8192), device='meta')
    idx = torch.empty((6, 4, 8192), dtype=torch.int32, device='meta')
    w = torch.empty((6, 4, 8192), device='meta')
    calls = [lambda: thw.hash_window_fwd(table, pos, lo, lo, tcfg),
             lambda: thw.hash_window_fwd_stoch(table, pos, lo, lo, tcfg, 4, 1,
                                               save=True),
             lambda: thw.hash_window_bwd(g, pos, lo, lo, tcfg, 32),
             lambda: thw.hash_window_bwd_cached(g, idx, w, 32)]
    for call in calls:
        with pytest.raises(KernelError):
            call()


# ---------------------------------------------------------------------------
# table gradients: #2 (exact, recomputed corners) and #3 (saved streams)
# ---------------------------------------------------------------------------

def _grad_inputs(jcfg, n, seed):
    pos = _sorted_positions(n, seed=seed)
    lo, win = jhw.window_bases(jnp.asarray(pos), jcfg)
    g = np.random.default_rng(seed + 1).normal(
        size=(2 * jcfg.num_levels, n)).astype(np.float32)
    return pos, lo, win, g


@pytest.mark.parametrize('args', CONFIGS[:2])
def test_bwd_matches_oracle(args):
    """``hash_window_bwd`` (plain) against ``_bwd_jnp`` on the same windows."""
    jcfg, tcfg = _configs(args)
    pos, lo, win, g = _grad_inputs(jcfg, 16384, seed=5)
    rows = jcfg.table_size // 128
    shape = (jcfg.num_levels, 2, rows, 128)
    want = np.asarray(jhw._bwd_jnp(shape, jnp.asarray(pos), jnp.asarray(g),
                                   jcfg, lo, win))
    got = thw.hash_window_bwd(torch.from_numpy(g), torch.from_numpy(pos),
                              torch.from_numpy(np.array(lo)),
                              torch.from_numpy(np.array(win)), tcfg, rows)
    np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)


@pytest.mark.parametrize('n', [8192, 10000])
def test_encode_grad_matches_jax(n):
    """torch.autograd through the port's hash_encode_win against jax.grad
    through the JAX one, with anchor keys, including a padded batch."""
    jcfg, tcfg = _configs(CONFIGS[0])
    pos = _sorted_positions(n, seed=6)
    table = _table(jcfg, seed=7)
    anchors = np.array(jhw.morton_sort_keys(jnp.asarray(pos)))[::8]
    cot = np.random.default_rng(8).normal(
        size=(2 * jcfg.num_levels, n)).astype(np.float32)

    def loss(t):
        out = jhw.hash_encode_win(t, jnp.asarray(pos), jcfg,
                                  jnp.asarray(anchors))
        return jnp.sum(out * cot)

    want = np.asarray(jax.grad(loss)(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_()
    out = thw.hash_encode_win(t, torch.from_numpy(pos), tcfg,
                              torch.from_numpy(anchors))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, **GRAD_TOL)


def test_bwd_cached_plain_scatters_its_streams():
    """#3's plain version equals an index_add_ of the same corners, and fed
    the 8 exact corners as streams it equals ``_bwd_jnp``."""
    jcfg, tcfg = _configs(CONFIGS[0])
    pos, lo, win, g = _grad_inputs(jcfg, 8192, seed=9)
    rows = jcfg.table_size // 128
    pos_t, g_t = torch.from_numpy(pos), torch.from_numpy(g)
    lo_t, win_t = torch.from_numpy(np.array(lo)), torch.from_numpy(np.array(win))
    table = torch.from_numpy(_table(jcfg, seed=10))
    _, idx, w = thw.hash_window_fwd_stoch(table, pos_t, lo_t, win_t, tcfg, 4,
                                          1234, save=True)
    got = thw.hash_window_bwd_cached(g_t, idx, w, rows)
    want = torch.zeros((jcfg.num_levels, 2, rows * 128))
    for lv in range(jcfg.num_levels):
        for f in range(2):
            for c in range(4):
                want[lv, f].index_add_(0, idx[lv, c].long(),
                                       g_t[2 * lv + f] * w[lv, c])
    np.testing.assert_allclose(got.reshape(want.shape).numpy(),
                               want.numpy(), **GRAD_TOL)

    lay = thw.window_layout(tcfg)
    exact = [thw._exact_corners(pos_t, lay, lv, lo_t, win_t)
             for lv in range(jcfg.num_levels)]
    idx8 = torch.stack([i.T for i, _ in exact]).to(torch.int32)
    w8 = torch.stack([wt.T for _, wt in exact])
    want = np.asarray(jhw._bwd_jnp((jcfg.num_levels, 2, rows, 128),
                                   jnp.asarray(pos), jnp.asarray(g), jcfg,
                                   lo, win))
    # The streams add corner-major, the oracle sample-major: at the coarsest
    # level an entry sums ~1000 products, so the f32 error scales with the
    # largest entry (atol 1e-6 of it) rather than with the entry itself.
    np.testing.assert_allclose(
        thw.hash_window_bwd_cached(g_t, idx8, w8, rows).numpy(), want,
        rtol=1e-5, atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize('n_corners', [1, 2, 4])
def test_stochastic_encode_grad_is_its_streams(n_corners):
    """Autograd through hash_encode_win_stochastic scatters exactly the
    corners and weights its forward used (#3 on the saved streams), and a
    call without gradient gives the same features."""
    jcfg, tcfg = _configs(CONFIGS[0])
    pos = torch.from_numpy(_sorted_positions(10000, seed=11))
    table = torch.from_numpy(_table(jcfg, seed=12)).requires_grad_()
    cot = torch.from_numpy(np.random.default_rng(13).normal(
        size=(2 * jcfg.num_levels, 10000)).astype(np.float32))
    out = thw.hash_encode_win_stochastic(table, pos, 77, tcfg, n_corners)
    (out * cot).sum().backward()
    pos_p, n = tcommon.pad_positions(pos, thw.SUB_BLOCK * 128)
    lo, win = thw.window_bases(pos_p, tcfg)
    _, idx, w = thw.hash_window_fwd_stoch(table.detach(), pos_p, lo, win,
                                          tcfg, n_corners, 77, save=True)
    g = torch.nn.functional.pad(cot, (0, pos_p.shape[0] - n))
    want = thw.hash_window_bwd_cached_plain(g, idx, w, table.shape[2])
    np.testing.assert_allclose(table.grad.numpy(), want.numpy(), **GRAD_TOL)
    with torch.no_grad():
        again = thw.hash_encode_win_stochastic(table, pos, 77, tcfg,
                                               n_corners)
    assert torch.equal(again, out.detach())
