"""The crossbar forward's two paths (nerficg_torch/ops/hash_xbar.py
``hash_xbar_fwd``, kernel #10) on the CPU, where the wrapper takes its
plain version.

* (a) ``xbar_fwd_plan`` is a function of the shapes: the level-resident path
  for 2^12 and 2^14 tables at and above ``FWD_MIN_SAMPLES`` samples, the
  gather path for 2^16 and 2^19 tables and for smaller calls; one wave of
  blocks, never more tiles than chunks of samples; the Python constants
  are the kernel's.
* (b) The kernels' summation, each feature the sum over the corners in
  order of the rounded products w_c * v_c, emulated here in f32, equals
  ``hash_xbar_fwd_plain`` bit for bit, exact and at 1/2/4 corners; the
  fused form (an FMA per corner) does not. Both paths of the kernel use it,
  so they give the same bits on the card.
* (c) The plain forward agrees with the JAX package's oracle ``_fwd_jnp``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.core.errors import KernelError
from nerficg_torch.ops import hash_xbar as txb
from nerficg_torch.ops._hash_common import bf16_planes
from nerficg_torch.ops.hashgrid import HashGridConfig as TConfig
from nerficg_tpu.ops import hash_xbar as jxb
from nerficg_tpu.ops.hashgrid import HashGridConfig as JConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

KW = dict(num_levels=4, features_per_level=2, log2_table_size=11,
          base_resolution=4, target_resolution=64)
SOURCE = Path(txb.__file__).resolve().parents[1] / 'csrc' / 'hash_xbar.cu'


def _library_config(log2):
    return TConfig(num_levels=16, features_per_level=2, log2_table_size=log2,
                   base_resolution=16, target_resolution=2048)


@pytest.mark.parametrize('log2, n, path', [
    (12, 262144, 'resident'), (14, 262144, 'resident'),
    (14, 196608, 'resident'), (14, 65536, 'resident'),
    (14, txb.FWD_MIN_SAMPLES, 'resident'),
    (14, txb.FWD_MIN_SAMPLES - 1, 'gather'), (14, 1, 'gather'),
    (16, 262144, 'gather'), (19, 262144, 'gather')])
def test_launch_plan_follows_the_shapes(log2, n, path):
    cfg = _library_config(log2)
    plan = txb.xbar_fwd_plan(cfg, n)
    assert plan.path == path
    assert plan.level_rows == (1 << log2) // 128
    if path == 'gather':
        assert plan.tiles == 0 and plan.smem_bytes == 0
        return
    assert plan.smem_bytes == txb.FWD_LEVELS * plan.level_rows * 128 * 4
    assert plan.smem_bytes <= 232_448
    chunks = -(-n // txb.FWD_THREADS)
    per_sm = max(1, min(233_472 // (plan.smem_bytes + 1024),
                        3 // txb.FWD_LEVELS, 1536 // txb.FWD_THREADS))
    assert plan.tiles == min(chunks, 132 * per_sm // (16 // txb.FWD_LEVELS))
    # Another card's limits, and a block of 512 threads owning one level.
    assert txb.xbar_fwd_plan(cfg, n, sms=66).tiles <= plan.tiles
    single = txb.xbar_fwd_plan(cfg, n, threads=512, group=1)
    assert single.smem_bytes == plan.level_rows * 128 * 4
    single_per_sm = min(233_472 // (single.smem_bytes + 1024), 3)
    assert single.tiles == min(-(-n // 512), 132 * single_per_sm // 16)


def test_plan_constants_are_the_kernels():
    text = SOURCE.read_text()

    def const(name):
        return int(re.search(rf'constexpr int {name} = (\d+);', text)[1])
    assert txb.FWD_THREADS == const('kFwdThreads')
    assert txb.FWD_LEVELS == const('kFwdLevels')
    assert 16 % txb.FWD_LEVELS == 0


def _kernel_sum(table, pos, cfg, n_corners, seed, fused=False):
    """The kernels' per-feature sum emulated in f32 (``fused``: an FMA per
    corner, emulated in f64 and rounded once)."""
    flat = bf16_planes(table)
    outs = []
    for lv in range(table.shape[0]):
        idx, w = txb.xbar_corners(pos, cfg, lv, n_corners, seed)
        vals = flat[lv][:, idx]                                 # (2, N, C)
        acc = torch.zeros((2, pos.shape[0]))
        for c in range(idx.shape[1]):
            if fused:
                acc = (w[:, c].double() * vals[:, :, c].double()
                       + acc.double()).float()
            else:
                acc = acc + w[:, c] * vals[:, :, c]
        outs.append(acc)
    return torch.cat(outs, 0).T


@pytest.mark.parametrize('n_corners', [0, 1, 2, 4])
def test_kernel_summation_is_the_plain_versions(n_corners):
    rng = np.random.default_rng(n_corners)
    cfg = _library_config(14)
    table = torch.from_numpy(rng.uniform(-1, 1, (16, 2, 128, 128)).astype(
        np.float32))
    pos = torch.from_numpy(rng.uniform(0, 1 - 1e-6, (3000, 3)).astype(
        np.float32))
    want = txb.hash_xbar_fwd(table, pos, cfg, n_corners, 0xBEEF)
    assert torch.equal(want, txb.hash_xbar_fwd_plain(table, pos, cfg,
                                                     n_corners, 0xBEEF))
    got = _kernel_sum(table, pos, cfg, n_corners, 0xBEEF)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if n_corners != 1:   # one corner: no sum
        fused = _kernel_sum(table, pos, cfg, n_corners, 0xBEEF, fused=True)
        assert not torch.equal(fused, want)
        np.testing.assert_allclose(fused.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5)


def test_plain_forward_matches_the_jax_oracle():
    rng = np.random.default_rng(5)
    table = rng.uniform(-1, 1, (4, 2, 16, 128)).astype(np.float32)
    pos = rng.uniform(0, 1 - 1e-6, (4000, 3)).astype(np.float32)
    got = txb.hash_xbar_fwd(torch.from_numpy(table), torch.from_numpy(pos),
                            TConfig(**KW))
    want = np.asarray(jxb._fwd_jnp(jnp.asarray(table), jnp.asarray(pos),
                                   JConfig(**KW)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_launcher_refuses_cpu_tensors():
    """On the CPU only the wrapper's plain version runs; the launcher
    itself raises before any library is loaded."""
    cfg = TConfig(**KW)
    table = torch.zeros((4, 2, 16, 128))
    pos = torch.zeros((8, 3))
    with pytest.raises(KernelError):
        txb._launch_fwd('hash_xbar_fwd', table, pos, cfg, 0, 0, False,
                        plan=txb.xbar_fwd_plan(cfg, 8))
