"""The port's masked metrics (``nerficg_torch/optim/masked_metrics.py``)
against the JAX package on the CPU: ``masked_psnr`` and dycheck's
partial-convolution ``masked_ssim`` under 2-D and 3-D masks, a mask
covering everything and an empty one (where a fully masked window scores
1 and the mean runs over every window), within ATOL; and
``compute_masked_metrics``, its mLPIPS from the LPIPS weights file (the
JAX package's ``lpips_available`` pointed at that file, as in
tests/test_torch_lpips.py) or NaN without one."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.optim import masked_metrics as tmm
from nerficg_tpu.optim import masked_metrics as jmm
from test_torch_lpips import (RTOL, jax_params, npz,  # noqa: F401
                              with_weights, without_weights)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-5


def _images(shape=(29, 37, 3), seed=0):
    rng = np.random.default_rng(seed)
    pred = rng.random(shape).astype(np.float32)
    target = np.clip(pred + 0.1 * rng.standard_normal(shape), 0, 1
                     ).astype(np.float32)
    return pred, target


def _masks(shape=(29, 37)):
    rng = np.random.default_rng(1)
    blob = np.zeros(shape, np.float32)
    blob[5:20, 8:30] = 1.0
    return {
        'random_2d': rng.random(shape).astype(np.float32),
        'blob_3d': blob[..., None],
        'per_channel_3d': (rng.random(shape + (3,)) > 0.3).astype(np.float32),
        'all': np.ones(shape, np.float32),
        'empty': np.zeros(shape, np.float32),
    }


@pytest.mark.parametrize('mask_name', list(_masks()))
@pytest.mark.parametrize('metric', ['masked_psnr', 'masked_ssim'])
def test_masked_metric_matches_jax(metric, mask_name):
    pred, target = _images()
    mask = _masks()[mask_name]
    want = float(getattr(jmm, metric)(jnp.asarray(pred), jnp.asarray(target),
                                      jnp.asarray(mask)))
    got = float(getattr(tmm, metric)(torch.from_numpy(pred),
                                     torch.from_numpy(target),
                                     torch.from_numpy(mask)))
    assert math.isfinite(got)
    assert got == pytest.approx(want, abs=ATOL)


def test_empty_mask_quirks():
    """No pixel: PSNR of a zero error (120 dB) and SSIM 1 in every window."""
    pred, target = _images()
    empty = torch.zeros(pred.shape[:2])
    p, t = torch.from_numpy(pred), torch.from_numpy(target)
    assert float(tmm.masked_psnr(p, t, empty)) == pytest.approx(120.0)
    assert float(tmm.masked_ssim(p, t, empty)) == pytest.approx(1.0)


def test_compute_masked_metrics_with_weights(with_weights):
    pred, target = _images((40, 44, 3), seed=2)
    mask = _masks((40, 44))['blob_3d']
    got = tmm.compute_masked_metrics(pred, target, mask)
    want = jmm.compute_masked_metrics(pred, target, mask)
    assert list(got) == list(want) == ['mPSNR', 'mSSIM', 'mLPIPS']
    assert got['mPSNR'] == pytest.approx(want['mPSNR'], abs=ATOL)
    assert got['mSSIM'] == pytest.approx(want['mSSIM'], abs=ATOL)
    assert got['mLPIPS'] > 0
    assert got['mLPIPS'] == pytest.approx(want['mLPIPS'], rel=RTOL)


def test_compute_masked_metrics_without_weights(without_weights):
    pred, target = _images()
    got = tmm.compute_masked_metrics(pred, target, _masks()['random_2d'])
    want = jmm.compute_masked_metrics(pred, target, _masks()['random_2d'])
    assert math.isnan(got['mLPIPS']) and math.isnan(want['mLPIPS'])
    assert got['mSSIM'] == pytest.approx(want['mSSIM'], abs=ATOL)
