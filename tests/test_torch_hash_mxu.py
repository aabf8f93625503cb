"""Parity of the port's segment gather / scatter-add (nerficg_torch/ops/
hash_mxu.py) with the JAX package's ``gather_d`` / ``scatter_add_d``
(nerficg_tpu/ops/hash_mxu.py), whose CPU path is the oracle
``_mxu_gather_jnp`` / ``_mxu_scatter_jnp``. The gather moves values and must
agree exactly; the scatter sums and agrees to 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.core.errors import KernelError
from nerficg_torch.ops import hash_mxu as tmx
from nerficg_tpu.ops import hash_mxu as jmx
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL_SCATTER = 1e-5


def _ids(levels, m, size, seed=0, sorted_ids=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, size, (levels, m)).astype(np.int32)
    return np.sort(ids, axis=1) if sorted_ids else ids


@pytest.mark.parametrize('levels,feats,rows,m', [(1, 1, 13, 24576),
                                                 (2, 5, 3, 1000),
                                                 (4, 2, 8, 777)])
def test_gather_matches(levels, feats, rows, m):
    rng = np.random.default_rng(1)
    table = rng.normal(size=(levels, feats, rows, 128)).astype(np.float32)
    idx = _ids(levels, m, rows * 128)
    want = np.asarray(jmx.gather_d(jnp.asarray(idx), jnp.asarray(table)))
    got = tmx.seg_gather(torch.from_numpy(idx), torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('levels,feats,rows,m', [(1, 1, 13, 24576),
                                                 (2, 3, 2, 777)])
def test_gather_negative_and_out_of_range_ids_match_oracle(levels, feats,
                                                           rows, m):
    """Ids in [-2 size, 2 size): those in [-size, -1] count from the end
    and the others clamp into [0, size - 1], as ``_mxu_gather_jnp``'s JAX
    indexing does; the plain version agrees exactly, the edges included."""
    size = rows * 128
    rng = np.random.default_rng(3)
    table = rng.normal(size=(levels, feats, rows, 128)).astype(np.float32)
    idx = rng.integers(-2 * size, 2 * size, (levels, m)).astype(np.int32)
    idx[0, :6] = [-1, -size, -size - 1, size - 1, size, -2 * size]
    want = np.asarray(jmx._mxu_gather_jnp(jnp.asarray(idx),
                                          jnp.asarray(table)))
    got = tmx.seg_gather_plain(torch.from_numpy(idx), torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), want)
    flat = table.reshape(levels, feats, size)
    np.testing.assert_array_equal(
        got.numpy()[0, :, :6],
        flat[0][:, [size - 1, 0, 0, size - 1, size - 1, 0]])


@pytest.mark.parametrize('levels,feats,rows,m,sorted_ids',
                         [(1, 5, 13, 24576, True), (1, 1, 13, 24576, True),
                          (3, 2, 4, 5000, False)])
def test_scatter_add_matches(levels, feats, rows, m, sorted_ids):
    rng = np.random.default_rng(2)
    g = rng.uniform(-1, 1, (levels, feats, m)).astype(np.float32)
    idx = _ids(levels, m, rows * 128, sorted_ids=sorted_ids)
    want = np.asarray(jmx.scatter_add_d(jnp.asarray(idx), jnp.asarray(g),
                                        rows))
    got = tmx.seg_scatter_add(torch.from_numpy(idx), torch.from_numpy(g),
                              rows)
    assert got.shape == (levels, feats, rows, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_SCATTER)


def test_wrappers_refuse_non_cpu_tensors_without_a_kernel():
    idx = torch.empty((1, 8), dtype=torch.int32, device='meta')
    table = torch.empty((1, 1, 2, 128), device='meta')
    with pytest.raises(KernelError):
        tmx.seg_gather(idx, table)
    with pytest.raises(KernelError):
        tmx.seg_scatter_add(idx, torch.empty((1, 1, 8), device='meta'), 2)


def _meta(shape, dtype=torch.float32):
    """A tensor that is on no CPU, so the wrappers take the kernel path and
    must refuse it before any launch (there is no card here)."""
    return torch.empty(shape, dtype=dtype, device='meta')


@pytest.mark.parametrize('call,message', [
    # a CPU tensor beside a non-CPU one (the first tensor, idx, is named)
    (lambda: tmx.seg_gather(torch.zeros((1, 8), dtype=torch.int32),
                            _meta((1, 1, 2, 128))),
     'seg_gather: all inputs must be on one CUDA device, got cpu and cpu'),
    (lambda: tmx.seg_scatter_add(torch.zeros((1, 8), dtype=torch.int32),
                                 _meta((1, 1, 8)), 2),
     'seg_scatter_add: all inputs must be on one CUDA device, got cpu and '
     'cpu'),
    # wrong dtypes
    (lambda: tmx.seg_gather(_meta((1, 8), torch.int64), _meta((1, 1, 2, 128))),
     'seg_gather: expected torch.int32, got torch.int64'),
    (lambda: tmx.seg_scatter_add(_meta((1, 8), torch.int32),
                                 _meta((1, 1, 8), torch.float64), 2),
     'seg_scatter_add: expected torch.float32, got torch.float64'),
    # non-contiguous inputs
    (lambda: tmx.seg_gather(_meta((1, 16), torch.int32)[:, ::2],
                            _meta((1, 1, 2, 128))),
     'seg_gather: inputs must be contiguous'),
    (lambda: tmx.seg_scatter_add(_meta((1, 8), torch.int32),
                                 _meta((1, 1, 16))[..., ::2], 2),
     'seg_scatter_add: inputs must be contiguous'),
    # shapes
    (lambda: tmx.seg_scatter_add(_meta((1, 8), torch.int32),
                                 _meta((1, 1, 9)), 2),
     'seg_scatter_add: idx and g disagree on M'),
    (lambda: tmx.seg_scatter_add(_meta((2, 8), torch.int32),
                                 _meta((1, 1, 8)), 2),
     r'seg_scatter_add: idx must be \(1, M\), got \(2, 8\)'),
    (lambda: tmx.seg_scatter_add(_meta((1, 8), torch.int32), _meta((1, 8)),
                                 2),
     r'seg_scatter_add: g must be \(L, F, M\)'),
    (lambda: tmx.seg_gather(_meta((1, 8), torch.int32), _meta((1, 1, 2, 64))),
     r'seg_gather: table must be \(L, F, R, 128\)'),
])
def test_wrapper_refusals_keep_their_messages(call, message):
    """Every check of the kernel path still raises KernelError with its
    message: device, dtype, contiguity, shape."""
    with pytest.raises(KernelError, match=message):
        call()
