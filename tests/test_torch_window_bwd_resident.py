"""The level-resident design of the exact window table gradient (#2,
nerficg_torch/csrc/hash_window.cu) on the CPU, against the JAX package's
oracle ``_bwd_jnp`` (nerficg_tpu/ops/hash_window.py).

The kernel shares one accumulation with the cached gradient (#3): on a
table of at most BWD_MAX_ROWS rows a level, BWD_LEVEL_BLOCKS blocks share
each level, each taking a contiguous share of the samples in whole
128-sample groups and summing its share's corner products into its own
copy of the level's two planes in shared memory; the blocks' planes are
then added into the table. Wider tables take the global path, tiles of
kBwdGlobalTile samples adding to the table directly. Each sample's 8
corners come from its position, wrapped into its own 8192-sample
sub-block's window, so a share that crosses sub-blocks reads each
sample's window. The tests hold the block constants to the kernel's,
check the path choice, and emulate the split on the CPU (each block's
plane, then their sum) against ``_bwd_jnp`` within rtol 1e-4, atol 1e-5 x
max (the kernel's tolerance: f32 sums in another order), on sorted and
unsorted samples, padding samples (g = 0) and windows that wrap.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.ops import hash_window as thw
from nerficg_torch.ops.hashgrid import HashGridConfig as TConfig
from nerficg_tpu.ops import hash_window as jhw
from nerficg_tpu.ops.hashgrid import HashGridConfig as JConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SOURCE = Path(thw.__file__).resolve().parents[1] / 'csrc' / 'hash_window.cu'
SB_N = 8192
GROUP = 128
H100_SMEM = 232_448
# (levels, log2 table): 2^14 entries, 128 rows a level (the level path),
# and 2^16, 512 rows (the global path).
TABLES = {128: (8, 14), 512: (8, 16)}


def _const(name):
    return int(re.search(rf'constexpr int {name} = (\d+);',
                         SOURCE.read_text())[1])


def _configs(rows):
    levels, log2 = TABLES[rows]
    kw = dict(num_levels=levels, features_per_level=2, log2_table_size=log2,
              base_resolution=16, target_resolution=1024, anchor_stride=8)
    return JConfig(**kw), TConfig(**kw)


def _shares(n, path):
    """The kernel's split of n samples: [begin, end) per block of a level
    (level path), or per tile (global path)."""
    if path == 'level':
        blocks = thw.BWD_LEVEL_BLOCKS
        per = (-(-n // blocks) + GROUP - 1) // GROUP * GROUP
        starts = [min(n, b * per) for b in range(blocks)]
    else:
        per = _const('kBwdGlobalTile')
        starts = list(range(0, n, per))
    return [(s, min(n, s + per)) for s in starts]


def _emulate_bwd(g, pos, lo, win, tcfg, rows):
    """The kernel's accumulation on the CPU: per level, each block's plane
    of its share's corner products (entries outside the level dropped),
    then the planes' sum."""
    lay = thw.window_layout(tcfg)
    n = pos.shape[0]
    entries = rows * 128
    out = torch.zeros((tcfg.num_levels, 2, entries))
    for lv in range(tcfg.num_levels):
        idx, w = thw._exact_corners(pos, lay, lv, lo, win)
        for begin, end in _shares(n, thw.window_bwd_path(rows)):
            plane = torch.zeros((2, entries))
            part = slice(begin, end)
            keep = (idx[part] >= 0) & (idx[part] < entries)
            for f in range(2):
                prod = g[2 * lv + f, part, None] * w[part]
                plane[f].index_add_(0, idx[part][keep], prod[keep])
            out[lv] += plane
    return out.reshape(tcfg.num_levels, 2, rows, 128)


def _inputs(n, kind, seed):
    """Samples uniform in [0.2, 0.8]^3, morton-sorted unless ``unsorted``;
    a normal cotangent with its last 1000 samples and a random tenth of the
    others zero (padding)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32)
    if kind == 'sorted':
        keys = thw.morton_sort_keys(torch.from_numpy(pos)).numpy()
        pos = pos[np.argsort(keys, kind='stable')]
    g = rng.normal(size=(16, n)).astype(np.float32)
    g[:, n - 1000:] = 0.0
    g[:, rng.uniform(size=n) < 0.1] = 0.0
    return np.ascontiguousarray(pos), g


def test_block_constants_are_the_kernels():
    """The wrapper's mirror is the kernel's: blocks a level and the widest
    level a block keeps, which fits a block's shared memory on an H100;
    a block's chunk is whole 128-sample groups and whole warps."""
    assert thw.BWD_LEVEL_BLOCKS == _const('kBwdLevelBlocks')
    assert thw.BWD_MAX_ROWS == _const('kBwdMaxRows')
    assert thw.BWD_MAX_ROWS * 128 * 2 * 4 <= H100_SMEM
    threads = _const('kBwdThreads')
    assert threads % GROUP == 0 and threads <= 1024
    assert _const('kBwdGlobalTile') % threads == 0


@pytest.mark.parametrize('rows, path', [
    (128, 'level'), (512, 'global'), (4096, 'global'),
    (thw.BWD_MAX_ROWS, 'level'), (thw.BWD_MAX_ROWS + 1, 'global')])
def test_path_choice(rows, path):
    """The library's 2^14 table (128 rows) stays in shared memory; 2^16
    (512 rows) and the parity width 2^19 (4096) take the global path."""
    assert thw.window_bwd_path(rows) == path


@pytest.mark.parametrize('n', [8192, 16384, 3 * SB_N, 65536, 100 * GROUP])
@pytest.mark.parametrize('path', ['level', 'global'])
def test_shares_cover_the_samples_once(n, path):
    """Every sample lies in exactly one share; each share starts on a
    128-sample group. At 3 x 8192 samples a level's 16 shares of 1536
    cross the sub-block boundaries, so the kernel reads each sample's own
    window."""
    covered = np.zeros(n, dtype=int)
    shares = _shares(n, path)
    for begin, end in shares:
        assert begin % GROUP == 0 and begin <= end
        covered[begin:end] += 1
    assert (covered == 1).all()
    if (n, path) == (3 * SB_N, 'level'):
        assert any(b // SB_N != (e - 1) // SB_N for b, e in shares if e > b)


@pytest.mark.parametrize('rows, kind, n, wrap', [
    (128, 'sorted', 8192, False), (128, 'sorted', 16384, False),
    (128, 'unsorted', 16384, False), (128, 'sorted', 16384, True),
    (512, 'sorted', 8192, False), (512, 'sorted', 16384, True),
    (512, 'unsorted', 8192, False), (128, 'unsorted', 8192, True),
    (128, 'sorted', 3 * SB_N, False)])
def test_split_matches_oracle(rows, kind, n, wrap):
    """The emulated split against ``_bwd_jnp`` on the same windows: at 16,384
    samples a block's share (1024) stays within a sub-block, at 3 x 8192
    shares cross sub-blocks; ``wrap`` narrows every window to a third (at
    least 1 row), so that most corners wrap into it."""
    jcfg, tcfg = _configs(rows)
    pos, g = _inputs(n, kind, seed=n + rows)
    lo, win = thw.window_bases(torch.from_numpy(pos), tcfg)
    if wrap:
        win = torch.clamp(win // 3, min=1)
    want = np.asarray(jhw._bwd_jnp(
        (jcfg.num_levels, 2, rows, 128), jnp.asarray(pos), jnp.asarray(g),
        jcfg, jnp.asarray(lo.numpy()), jnp.asarray(win.numpy())))
    got = _emulate_bwd(torch.from_numpy(g), torch.from_numpy(pos), lo, win,
                       tcfg, rows)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))
    plain = thw.hash_window_bwd(torch.from_numpy(g), torch.from_numpy(pos),
                                lo, win, tcfg, rows)
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))
