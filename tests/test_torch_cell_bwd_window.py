"""The window invariant that the cell table gradient's kernel (#9,
nerficg_torch/csrc/hash_cell.cu) rests on, its plan, and its order of
summation, on the CPU against the JAX package (nerficg_tpu/ops/hash_cell.py).

A block of the kernel owns one (2048-sample sub-block, level) and, when the
sub-block's window fits its shared-memory budget, accumulates the
whole window there before flushing it into the table. That is right only
if every corner a sub-block's samples touch lies in base rows
[lo, lo + win) of its window, which the wrap guarantees: the tests hold the
port's windows and wrapped rows to JAX's ``cell_window_bases`` and
``_apply_window_jnp``, stragglers and a dense level's last row included,
then emulate the kernel's accumulation (per window, then flushed; or
straight into the table) against the oracle ``_bwd_jnp`` within 1e-5 of the
largest entry (sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.ops import hash_cell as thc
from nerficg_torch.ops import hash_window as thw
from nerficg_torch.ops.hashgrid import HashGridConfig as TConfig
from nerficg_tpu.ops import hash_cell as jhc
from nerficg_tpu.ops.hashgrid import HashGridConfig as JConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SB_N = 2048
H100_SMEM = 232_448
GRAD_ATOL_OF_MAX = 1e-5

# (levels, log2 table, base, target, anchor stride): dense, mid and bricked
# hash levels at a test size, and the library's width.
CONFIGS = [(6, 12, 4, 256, 8), (16, 14, 16, 2048, 8)]


def _configs(args):
    levels, log2, base, target, stride = args
    kw = dict(num_levels=levels, features_per_level=2, log2_table_size=log2,
              base_resolution=base, target_resolution=target,
              anchor_stride=stride)
    return JConfig(**kw), TConfig(**kw)


def _positions(kind, n=4 * SB_N, seed=0):
    """Samples in [0.05, 0.95]^3, morton-sorted. ``stragglers``: 64 samples
    moved into other sub-blocks at positions that are not anchors, so their
    cells fall outside their windows and wrap; ``edge``: the last sub-block
    ends at the box's far corner, so a dense level's window reaches its
    last base row; ``unsorted``: no order at all (wide windows)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    if kind == 'edge':
        pos[-16:] = 1.0 - 1e-6
    if kind != 'unsorted':
        keys = thw.morton_sort_keys(torch.from_numpy(pos)).numpy()
        pos = pos[np.argsort(keys, kind='stable')]
    if kind == 'stragglers':
        src = rng.choice(np.flatnonzero(np.arange(n) % 8 != 0), 64,
                         replace=False)
        pos[src] = pos[rng.permutation(src)]
    return np.ascontiguousarray(pos)


def _windows(pos, jcfg, tcfg):
    lo_j, win_j = jhc.cell_window_bases(jnp.asarray(pos), jcfg)
    lo_t, win_t = thc.cell_window_bases(torch.from_numpy(pos), tcfg)
    return np.asarray(lo_j), np.asarray(win_j), lo_t, win_t


@pytest.mark.parametrize('args', CONFIGS)
@pytest.mark.parametrize('kind', ['sorted', 'stragglers', 'edge',
                                  'unsorted'])
def test_wrapped_rows_match_jax(args, kind):
    """Windows equal JAX's; each sample's wrapped base row equals
    ``_apply_window_jnp``'s and lies in its sub-block's window; the
    stragglers and the dense edge occur where the inputs put them."""
    jcfg, tcfg = _configs(args)
    pos = _positions(kind)
    lo_j, win_j, lo_t, win_t = _windows(pos, jcfg, tcfg)
    np.testing.assert_array_equal(lo_t.numpy(), lo_j)
    np.testing.assert_array_equal(win_t.numpy(), win_j)
    raw, _, _ = jhc._cell_rows_lanes_w_jnp(jnp.asarray(pos), jcfg)
    want = np.asarray(jhc._apply_window_jnp(raw, jnp.asarray(lo_j),
                                            jnp.asarray(win_j), 16))
    lay = thc.cell_layout(tcfg)
    sb = np.arange(pos.shape[0]) // SB_N
    wrapped = 0
    for lv in range(jcfg.num_levels):
        idx, _ = thc._cell_corners(torch.from_numpy(pos), lay, lv, lo_t,
                                   win_t)
        brow = (idx[:, 0] // (8 * 128)).numpy()
        np.testing.assert_array_equal(brow, want[lv])
        lo_s, win_s = lo_j[lv][sb], win_j[lv][sb]
        assert ((brow >= lo_s) & (brow < lo_s + win_s)).all()
        raw_l = np.asarray(raw[lv])
        wrapped += int(((raw_l < lo_s) | (raw_l >= lo_s + win_s)).sum())
        if kind == 'edge' and lay.dense[lv]:
            assert lo_j[lv][-1] + win_j[lv][-1] == lay.base_rows[lv]
    if kind == 'stragglers':
        assert wrapped > 0


@pytest.mark.parametrize('args', CONFIGS)
@pytest.mark.parametrize('kind', ['sorted', 'stragglers', 'unsorted'])
def test_every_corner_lies_in_its_window(args, kind):
    """Every flat index ``hash_cell_bwd_plain`` adds to is a corner row
    base_row * 8 + c of its sub-block's window [lo, lo + win) x 8 rows."""
    _, tcfg = _configs(args)
    pos = torch.from_numpy(_positions(kind, seed=1))
    lo, win = thc.cell_window_bases(pos, tcfg)
    lay = thc.cell_layout(tcfg)
    sb = torch.arange(pos.shape[0]) // SB_N
    for lv in range(tcfg.num_levels):
        idx, _ = thc._cell_corners(pos, lay, lv, lo, win)
        row = idx // 128
        first = (lo[lv].long() * 8)[sb][:, None]
        assert ((row >= first) &
                (row < first + (win[lv].long() * 8)[sb][:, None])).all()
        assert torch.equal(row - row[:, :1], torch.arange(8).expand_as(row))


def _emulate_bwd(g, pos, lo, win, tcfg, rows, resident):
    """The kernel's order on the CPU: per (level, sub-block) block, the
    window's two features accumulated in a buffer of win * 1024 entries
    each and then added into the table (``resident``), or every product
    added into the table straight away (global)."""
    lay = thc.cell_layout(tcfg)
    levels = tcfg.num_levels
    table = torch.zeros((levels, 2, rows * 128))
    for lv in range(levels):
        idx, w = thc._cell_corners(pos, lay, lv, lo, win)
        vals = g[2 * lv:2 * lv + 2, :, None] * w[None]
        for sb in range(lo.shape[1]):
            part = slice(sb * SB_N, (sb + 1) * SB_N)
            ind, val = idx[part].reshape(-1), vals[:, part].reshape(2, -1)
            if resident[lv, sb]:
                first = int(lo[lv, sb]) * 1024
                span = int(win[lv, sb]) * 1024
                buf = torch.zeros((2, span)).index_add_(1, ind - first, val)
                table[lv, :, first:first + span] += buf
            else:
                table[lv].index_add_(1, ind, val)
    return table.reshape(levels, 2, rows, 128)


@pytest.mark.parametrize('args', CONFIGS)
@pytest.mark.parametrize('kind', ['sorted', 'stragglers', 'unsorted'])
@pytest.mark.parametrize('budget, forced', [(thc.BWD_WIN_ROWS, ()),
                                            (2, ()), (28, (0, 3)),
                                            (12, tuple(range(16)))])
def test_window_accumulation_matches_jax_bwd(args, kind, budget, forced):
    """The order is right for any budget (a ``:kWinRows=N`` build of the
    kernel) and any forced levels; at BWD_WIN_ROWS the blocks' paths are
    ``cell_bwd_paths``'s."""
    jcfg, tcfg = _configs(args)
    pos = _positions(kind, seed=2)
    lo_j, win_j, lo, win = _windows(pos, jcfg, tcfg)
    g = np.random.default_rng(3).normal(
        size=(2 * jcfg.num_levels, pos.shape[0])).astype(np.float32)
    rows = jcfg.table_size // 128
    shape = (jcfg.num_levels, 2, rows, 128)
    want = np.asarray(jhc._bwd_jnp(shape, jnp.asarray(pos), jnp.asarray(g),
                                   jcfg, jnp.asarray(lo_j),
                                   jnp.asarray(win_j)))
    forced = tuple(lv for lv in forced if lv < tcfg.num_levels)
    kept = torch.tensor([lv not in forced for lv in range(tcfg.num_levels)])
    resident = (win <= budget) & kept[:, None]
    if budget == thc.BWD_WIN_ROWS:
        assert torch.equal(resident, thc.cell_bwd_paths(win, forced))
    got = _emulate_bwd(torch.from_numpy(g), torch.from_numpy(pos), lo, win,
                       tcfg, rows, resident)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=GRAD_ATOL_OF_MAX * np.abs(want).max())


@pytest.mark.parametrize('args', CONFIGS + [(16, 19, 16, 2048, 8)])
def test_plan_on_the_ports_configs(args):
    """The budget fits a block's shared memory on an H100; the finest
    level of dense morton-sorted samples keeps some windows resident on
    every table, and on the reference's 2^19 the coarsest does too (the
    library's 2^14 planes are 16 base rows, all of them a coarse window)."""
    _, tcfg = _configs(args)
    assert thc.BWD_WIN_ROWS * thc.WIN_ROW_BYTES <= H100_SMEM
    pos = torch.from_numpy(_positions('sorted', n=32 * SB_N, seed=4) * 0.25
                           + 0.375)
    _, win = thc.cell_window_bases(pos, tcfg)
    resident = thc.cell_bwd_paths(win)
    assert bool(resident[-1].any())
    assert bool(resident[0].any()) == (tcfg.log2_table_size != 14)


@pytest.mark.parametrize('width, resident', [
    (1, True), (thc.BWD_WIN_ROWS - 1, True), (thc.BWD_WIN_ROWS, True),
    (thc.BWD_WIN_ROWS + 1, False), (2 * thc.BWD_WIN_ROWS, False),
    (512, False)])
def test_plan_budget_edges(width, resident):
    """A window of at most BWD_WIN_ROWS base rows is resident, one row more
    is not, and a forced level is global whatever its width while the
    other levels keep their paths."""
    win = torch.full((6, 3), width, dtype=torch.int32)
    assert thc.cell_bwd_paths(win).tolist() == [[resident] * 3] * 6
    assert thc.cell_bwd_paths(win, (2,)).tolist() == [
        [resident and lv != 2] * 3 for lv in range(6)]


def test_paths_at_the_budget_edge():
    """A window of exactly the budget is resident, one row more is not;
    forcing one level leaves the others as they were."""
    b = thc.BWD_WIN_ROWS
    win = torch.tensor([[b - 1, b, b + 1], [1, b, b + 1], [1, 2, 3]],
                       dtype=torch.int32)
    assert thc.cell_bwd_paths(win, (2,)).tolist() == [
        [True, True, False], [True, True, False], [False, False, False]]
    assert thc.cell_bwd_paths(win).tolist() == [
        [True, True, False], [True, True, False], [True, True, True]]
