"""The port's stochastic corners against the JAX package's, on the CPU.

The TPU kernels draw corner bits with ``pltpu.prng_random_bits``, which JAX
has only on the TPU; the port draws them from its own counter hash
(nerficg_torch/ops/counter_rng.py). So the two cannot draw the same bits.
What is compared instead:
  * the corner logic: JAX ``_stoch_corners`` (with ``pltpu`` stubbed to hand
    it the test's words) and the port's ``stoch_corners`` on the same bits
    choose equal corners, with weights equal to 1e-7;
  * the distribution: the port's stochastic encode is unbiased, its mean over
    512 seeds within 5 standard errors of the exact encode.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.ops import _hash_common as tcommon
from nerficg_torch.ops import counter_rng
from nerficg_torch.ops import hash_window as thw
from nerficg_torch.ops.hashgrid import HashGridConfig
from nerficg_tpu.ops import hash_xbar as jxbar
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _pltpu_stub(words):
    """pltpu stand-in: prng_random_bits hands out ``words`` in order (as
    int32, as the TPU returns them); bitcast is a plain bit reinterpret."""
    queue = [jnp.asarray(w.view(np.int32)) for w in words]
    return types.SimpleNamespace(
        prng_random_bits=lambda shape: queue.pop(0),
        bitcast=jax.lax.bitcast_convert_type)


@pytest.mark.parametrize('n_corners', [1, 2, 4])
def test_stoch_corners_match_jax_on_the_same_bits(monkeypatch, n_corners):
    rng = np.random.default_rng(n_corners)
    frac = rng.uniform(0, 1, (3, 64, 128)).astype(np.float32)
    # Exact ties and ends exercise the >= / <= rules of the dim choice.
    frac[:, 0, :] = 0.5
    frac[0, 1, :] = 0.25
    frac[1, 1, :] = 0.75
    frac[:, 2, :4] = 0.0
    words = rng.integers(0, 2 ** 32, (3, 64, 128), dtype=np.uint64).astype(
        np.uint32)
    monkeypatch.setattr(jxbar, 'pltpu', _pltpu_stub(words))
    j_corners, j_weights = jxbar._stoch_corners(
        tuple(jnp.asarray(f) for f in frac), n_corners)
    t_corners, t_weights = tcommon.stoch_corners(
        tuple(torch.from_numpy(f) for f in frac),
        tuple(torch.from_numpy(w.astype(np.int64)) for w in words),
        n_corners)
    assert len(t_corners) == len(j_corners) == n_corners
    for jc, tc, jw, tw in zip(j_corners, t_corners, j_weights, t_weights):
        for d in range(3):
            np.testing.assert_array_equal(tc[d].numpy(), np.asarray(jc[d]))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                                   atol=1e-7)


def test_counter_words_are_uint32_hashes():
    """mul32 is exact modulo 2^32, and the words spread over 32 bits."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
    for c in (0x7FEB352D, 0x846CA68B, 2654435761):
        want = (x * np.uint64(c)) & np.uint64(0xFFFFFFFF)
        got = counter_rng.mul32(torch.from_numpy(x.astype(np.int64)), c)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    bits = counter_rng.corner_bits(5, 3, torch.arange(1 << 16), 1).numpy()
    assert bits.min() >= 0 and bits.max() < 2 ** 32
    assert len(np.unique(bits)) == 1 << 16          # a bijection of the index
    for b in (0, 15, 31):                           # every bit is fair
        assert abs(((bits >> b) & 1).mean() - 0.5) < 0.01


@pytest.mark.parametrize('n_corners', [1, 2, 4])
def test_stochastic_encode_is_unbiased(n_corners):
    """Mean over 512 seeds of the stochastic plain encode against the exact
    encode: |mean - exact| <= 5 standard errors of the mean (the seeds'
    sample standard deviation / sqrt(511)), +1e-6 for f32 rounding, for
    >= 99.9% of the elements.

    The samples keep every level's fractional offsets in [0.05, 0.95], so
    each corner draw has probability >= 0.05 and 512 seeds see both
    outcomes: near f = 0 a draw of probability ~1e-3 is all zeros over 512
    seeds, and the sample standard error (then 0) says nothing."""
    cfg = HashGridConfig(num_levels=4, features_per_level=2,
                         log2_table_size=12, base_resolution=4,
                         target_resolution=64, anchor_stride=1)
    rng = np.random.default_rng(21)
    cand = rng.uniform(0, 1, (60000, 3)).astype(np.float32)
    keep = np.ones(len(cand), bool)
    for res in cfg.level_resolutions():
        scaled = cand * np.float32(res - 1)
        frac = scaled - np.floor(scaled)
        keep &= ((frac >= 0.05) & (frac <= 0.95)).all(1)
    assert keep.sum() >= 8192
    pos = torch.from_numpy(cand[keep][:8192])
    pos = pos[torch.sort(thw.morton_sort_keys(pos), stable=True).indices]
    table = torch.from_numpy(rng.uniform(-1, 1, (4, 2, 32, 128)).astype(
        np.float32))
    lo, win = thw.window_bases(pos, cfg)
    exact = thw.hash_window_fwd(table, pos, lo, win, cfg).double()
    seeds = 512
    total = torch.zeros_like(exact)
    total_sq = torch.zeros_like(exact)
    for seed in range(seeds):
        out = thw.hash_window_fwd_stoch(table, pos, lo, win, cfg, n_corners,
                                        seed * 7919 + 1)[0].double()
        total += out
        total_sq += out * out
    mean = total / seeds
    var = torch.clamp(total_sq / seeds - mean * mean, min=0.0)
    stderr = torch.sqrt(var / (seeds - 1))
    within = (mean - exact).abs() <= 5.0 * stderr + 1e-6
    assert float(within.double().mean()) >= 0.999
