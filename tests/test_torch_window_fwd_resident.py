"""The window-resident design of the window encode's exact forward (#1,
nerficg_torch/csrc/hash_window.cu) on the CPU, against the JAX package
(nerficg_tpu/ops/hash_window.py).

A block of the kernel owns kFwdTile samples of one 8192-sample sub-block at
one level. When the sub-block's window fits its shared-memory budget,
FWD_WIN_ROWS rows of 128 bf16x2 words, the block stages the window's
entries [lo * 128, (lo + win) * 128) of both features, rounded to bf16,
and reads every corner from that copy; otherwise it gathers from the
table. The tests hold the block constants to the kernel's, count the
windows on each path (``window_fwd_paths``), emulate both paths on the
CPU bit for bit against the plain gather, and hold the plain version to
the oracle ``_fwd_jnp`` within atol 1e-5 (f32 sums in another order), on
windows on both sides of the budget, morton-sorted and unsorted.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.core.errors import KernelError
from nerficg_torch.ops import hash_window as thw
from nerficg_torch.ops._hash_common import bf16_planes
from nerficg_torch.ops.hashgrid import HashGridConfig as TConfig
from nerficg_tpu.ops import hash_window as jhw
from nerficg_tpu.ops.hashgrid import HashGridConfig as JConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SOURCE = Path(thw.__file__).resolve().parents[1] / 'csrc' / 'hash_window.cu'
SB_N = 8192
H100_SMEM = 232_448
ATOL_FEATURES = 1e-5
# A 2^16 table whose morton-sorted windows range over 19-512 rows, on both
# sides of the budget; the library's width (2^14), where every
# morton-sorted window of a serving chunk fits.
STRADDLE = (8, 16, 16, 1024, 8)
LIBRARY = (16, 14, 16, 2048, 8)


def _configs(args):
    levels, log2, base, target, stride = args
    kw = dict(num_levels=levels, features_per_level=2, log2_table_size=log2,
              base_resolution=base, target_resolution=target,
              anchor_stride=stride)
    return JConfig(**kw), TConfig(**kw)


def _positions(kind, n=2 * SB_N, seed=0):
    """Samples uniform in [0.2, 0.8]^3 (chip_smoke.py phase 2's),
    morton-sorted unless ``unsorted``."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32)
    if kind == 'sorted':
        keys = thw.morton_sort_keys(torch.from_numpy(pos)).numpy()
        pos = pos[np.argsort(keys, kind='stable')]
    return np.ascontiguousarray(pos)


def _table(tcfg, seed=1):
    rows = thw.window_layout(tcfg).r_pad
    return np.random.default_rng(seed).uniform(
        -1, 1, (tcfg.num_levels, 2, rows, 128)).astype(np.float32)


def _emulate_fwd(table, pos, lo, win, tcfg, resident):
    """The kernel's reads on the CPU: per (level, sub-block), every corner
    read from the staged window (its bf16-rounded entries from lo * 128 on)
    when ``resident``, else from the whole plane; then the plain version's
    weighted sum."""
    lay = thw.window_layout(tcfg)
    flat = bf16_planes(table)
    out = []
    for lv in range(tcfg.num_levels):
        idx, w = thw._exact_corners(pos, lay, lv, lo, win)
        vals = torch.empty((2,) + tuple(idx.shape))
        for sb in range(lo.shape[1]):
            part = slice(sb * SB_N, (sb + 1) * SB_N)
            if resident[lv, sb]:
                first = int(lo[lv, sb]) * 128
                staged = flat[lv][:, first:first + int(win[lv, sb]) * 128]
                local = idx[part] - first
                assert int(local.min()) >= 0
                assert int(local.max()) < staged.shape[1]
                vals[:, part] = staged[:, local]
            else:
                vals[:, part] = flat[lv][:, idx[part]]
        out.append((vals * w[None]).sum(-1))
    return torch.cat(out, 0)


def test_block_constants_are_the_kernels():
    """FWD_WIN_ROWS is the kernel's kFwdWinRows and fits a block's shared
    memory on an H100; both tiles split the sub-block evenly."""
    text = SOURCE.read_text()

    def const(name):
        return int(re.search(rf'constexpr int {name} = (\d+);', text)[1])
    assert thw.FWD_WIN_ROWS == const('kFwdWinRows')
    assert thw.FWD_WIN_ROWS * 128 * 4 <= H100_SMEM
    for tile in (const('kFwdTile'), const('kFwdTileLarge')):
        assert SB_N % tile == 0 and tile % const('kFwdThreads') == 0
    assert const('kFwdLargeN') % const('kFwdTileLarge') == 0


@pytest.mark.parametrize('args, kind, n, staged', [
    (STRADDLE, 'sorted', 3 * SB_N, 4), (STRADDLE, 'unsorted', 3 * SB_N, 3),
    (LIBRARY, 'sorted', 3 * SB_N, 45), (LIBRARY, 'sorted', 24 * SB_N, 384)])
def test_paths_count_the_windows(args, kind, n, staged):
    """``window_fwd_paths`` is the kernel's test, win <= FWD_WIN_ROWS: at
    the 2^16 table the windows fall on both paths; at the library's 2^14
    every morton-sorted window of a serving chunk's 196,608 samples fits,
    and 3 of 48 of a call of 24,576 do not (fewer samples, wider
    sub-blocks)."""
    _, tcfg = _configs(args)
    pos = torch.from_numpy(_positions(kind, n=n))
    _, win = thw.window_bases(pos, tcfg)
    paths = thw.window_fwd_paths(win)
    assert torch.equal(paths, win <= thw.FWD_WIN_ROWS)
    assert int(paths.sum()) == staged
    assert paths.numel() == tcfg.num_levels * n // SB_N


@pytest.mark.parametrize('width, resident', [
    (1, True), (thw.FWD_WIN_ROWS, True), (thw.FWD_WIN_ROWS + 1, False),
    (1024, False)])
def test_paths_at_the_budget_edge(width, resident):
    win = torch.full((4, 3), width, dtype=torch.int32)
    assert thw.window_fwd_paths(win).tolist() == [[resident] * 3] * 4


@pytest.mark.parametrize('args', [STRADDLE, LIBRARY])
@pytest.mark.parametrize('kind', ['sorted', 'unsorted'])
@pytest.mark.parametrize('budget', [thw.FWD_WIN_ROWS, 0, 128])
def test_staged_reads_equal_the_gather(args, kind, budget):
    """Both paths read the same bf16 values, whatever the budget (a
    ``:kFwdWinRows=N`` build; 0 sends every block to the global path):
    the emulated kernel equals the plain version bit for bit, every staged
    corner inside its window."""
    _, tcfg = _configs(args)
    pos = torch.from_numpy(_positions(kind, seed=2))
    lo, win = thw.window_bases(pos, tcfg)
    table = torch.from_numpy(_table(tcfg))
    got = _emulate_fwd(table, pos, lo, win, tcfg, win <= budget)
    want = thw.hash_window_fwd_plain(table, pos, lo, win, tcfg)
    assert torch.equal(got, want)


@pytest.mark.parametrize('kind', ['sorted', 'unsorted'])
def test_plain_forward_matches_oracle_across_the_budget(kind):
    """The plain version against ``_fwd_jnp`` on JAX's windows, at the
    table whose windows straddle the budget."""
    jcfg, tcfg = _configs(STRADDLE)
    pos = _positions(kind, seed=3)
    table = _table(tcfg, seed=4)
    lo, win = jhw.window_bases(jnp.asarray(pos), jcfg)
    want = np.asarray(jhw._fwd_jnp(jnp.asarray(table), jnp.asarray(pos),
                                   jcfg, lo, win))
    win_t = torch.from_numpy(np.array(win))
    paths = thw.window_fwd_paths(win_t)
    assert bool(paths.any()) and not bool(paths.all())
    got = thw.hash_window_fwd(torch.from_numpy(table), torch.from_numpy(pos),
                              torch.from_numpy(np.array(lo)), win_t, tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_FEATURES)


def test_launcher_refuses_cpu_tensors():
    """The launcher behind the wrapper takes CUDA tensors only: CPU
    tensors there raise, never reach the plain version."""
    _, tcfg = _configs(LIBRARY)
    rows = thw.window_layout(tcfg).r_pad
    table = torch.zeros((16, 2, rows, 128))
    pos = torch.zeros((SB_N, 3))
    lo = torch.zeros((16, 1), dtype=torch.int32)
    with pytest.raises(KernelError, match='hash_window_fwd'):
        thw._launch_fwd('hash_window_fwd', table, pos, lo, lo, tcfg)
