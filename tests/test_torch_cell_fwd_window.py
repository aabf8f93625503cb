"""The cell encode's forward (#8, nerficg_torch/csrc/hash_cell.cu) on the
CPU, against the JAX package (nerficg_tpu/ops/hash_cell.py).

A block of the kernel owns one (2048-sample sub-block, level) and gathers
its samples' corners from the table, each wrapped into the sub-block's
window of base rows [lo, lo + win). The tests hold the plain version to
the oracle ``_fwd_jnp`` within atol 1e-5 (f32 sums in another order) on
narrow and wide windows: morton-sorted, with stragglers and unsorted; and
hold the launcher to CUDA tensors.
"""

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

SB_N = 2048
ATOL_FEATURES = 1e-5
# A 2^14 table whose morton-sorted windows range over 2-16 base rows (the
# reference's 2^19 is the card's job); a 2^16 one whose windows are 7-64
# base rows; and the parity tests' small config, whose windows are all 1-4
# base rows.
STRADDLE = (8, 14, 16, 1024, 8)
WIDE = (8, 16, 16, 1024, 8)
SMALL = (6, 12, 4, 256, 8)


def _configs(args):
    levels, log2, base, target, stride = args
    kw = dict(num_levels=levels, features_per_level=2, log2_table_size=log2,
              base_resolution=base, target_resolution=target,
              anchor_stride=stride)
    return JConfig(**kw), TConfig(**kw)


def _positions(kind, n=8 * SB_N, seed=0):
    """Samples uniform in [0.2, 0.8]^3 (chip_smoke.py phase 2's),
    morton-sorted; ``stragglers``: 64 of them swapped across sub-blocks at
    positions that are not anchors, so their cells wrap; ``unsorted``: no
    order (wide windows)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32)
    if kind != 'unsorted':
        keys = thw.morton_sort_keys(torch.from_numpy(pos)).numpy()
        pos = pos[np.argsort(keys, kind='stable')]
    if kind == 'stragglers':
        src = rng.choice(np.flatnonzero(np.arange(n) % 8 != 0), 64,
                         replace=False)
        pos[src] = pos[rng.permutation(src)]
    return np.ascontiguousarray(pos)


def _table(tcfg, seed=1):
    rows = thc.cell_layout(tcfg).r_pad
    return np.random.default_rng(seed).uniform(
        -1, 1, (tcfg.num_levels, 2, rows, 128)).astype(np.float32)


@pytest.mark.parametrize('args', [STRADDLE, WIDE, SMALL])
@pytest.mark.parametrize('kind', ['sorted', 'stragglers', 'unsorted'])
def test_plain_forward_matches_oracle(args, kind):
    """The plain version against ``_fwd_jnp`` on JAX's windows, which the
    port's ``cell_window_bases`` reproduces exactly."""
    jcfg, tcfg = _configs(args)
    pos = _positions(kind, seed=3)
    table = _table(tcfg, seed=4)
    lo, win = jhc.cell_window_bases(jnp.asarray(pos), jcfg)
    want = np.asarray(jhc._fwd_jnp(jnp.asarray(table), jnp.asarray(pos),
                                   jcfg, lo, win))
    lo_t = torch.from_numpy(np.array(lo))
    win_t = torch.from_numpy(np.array(win))
    lo_p, win_p = thc.cell_window_bases(torch.from_numpy(pos), tcfg)
    assert torch.equal(lo_p, lo_t) and torch.equal(win_p, win_t)
    got = thc.hash_cell_fwd(torch.from_numpy(table), torch.from_numpy(pos),
                            lo_t, win_t, tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_FEATURES)


def test_launcher_refuses_cpu_tensors():
    """The launcher behind the wrapper takes CUDA tensors only: CPU
    tensors there raise, never reach the plain version."""
    _, tcfg = _configs(SMALL)
    rows = thc.cell_layout(tcfg).r_pad
    table = torch.zeros((6, 2, rows, 128))
    pos = torch.zeros((SB_N, 3))
    lo = torch.zeros((6, 1), dtype=torch.int32)
    with pytest.raises(KernelError, match='hash_cell_fwd'):
        thc._launch_fwd('hash_cell_fwd', table, pos, lo, lo, tcfg)
