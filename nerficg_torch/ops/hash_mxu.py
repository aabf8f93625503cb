"""Segment gather and scatter-add by flat table index, ported from
nerficg_tpu/ops/hash_mxu.py (the ``gather_d`` / ``scatter_add_d`` interface).

  seg_gather(idx, table)       : out[l, f, m] = table[l, f].flat[idx[l, m]]
  seg_scatter_add(idx, g, rows): out[l, f].flat[idx[l, m]] += g[l, f, m]

with idx (L, M) int32, table (L, F, R, 128) f32, g (L, F, M) f32. The TPU
builds one-hot matrices for its MXU (``_gather_kernel`` :65 and
``_scatter_kernel`` :144) because it has no vector gather and no atomics;
the CUDA kernels in ``nerficg_torch/csrc/seg_ops.cu`` index directly and
scatter with fp32 atomics. CPU tensors take the plain versions.

``gather_d`` and ``scatter_add_d`` are the differentiable forms
(nerficg_tpu/ops/hash_mxu.py:234-267): each is the other's transpose, so the
backward of either launches the other's kernel.
"""

from __future__ import annotations

import torch

from nerficg_torch.core.errors import KernelError
from nerficg_torch.ops import _kernels

__all__ = ['seg_gather', 'seg_scatter_add', 'seg_gather_plain',
           'seg_scatter_add_plain', 'gather_d', 'scatter_add_d']

LANES = 128


def seg_gather_plain(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain gather, the oracle ``_mxu_gather_jnp`` (hash_mxu.py:116)."""
    levels, feats, rows, _ = table.shape
    ind = idx.long()[:, None, :].expand(levels, feats, idx.shape[1])
    return torch.gather(table.reshape(levels, feats, rows * LANES), 2, ind)


def seg_scatter_add_plain(idx: torch.Tensor, g: torch.Tensor,
                          rows: int) -> torch.Tensor:
    """Plain scatter-add into a zero table, the oracle ``_mxu_scatter_jnp``
    (hash_mxu.py:205)."""
    levels, feats, m = g.shape
    out = torch.zeros((levels, feats, rows * LANES), dtype=g.dtype,
                      device=g.device)
    out.scatter_add_(2, idx.long()[:, None, :].expand(levels, feats, m), g)
    return out.reshape(levels, feats, rows, LANES)


def _check_idx(name: str, idx: torch.Tensor, levels: int) -> None:
    if idx.ndim != 2 or idx.shape[0] != levels:
        raise KernelError(f'{name}: idx must be ({levels}, M), got '
                          f'{tuple(idx.shape)}')


def seg_gather(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(L, F, M) gather; CUDA tensors launch the kernel, CPU tensors take
    ``seg_gather_plain``."""
    if table.is_cpu:
        return seg_gather_plain(idx, table)
    name = 'seg_gather'
    if table.ndim != 4 or table.shape[3] != LANES:
        raise KernelError(f'{name}: table must be (L, F, R, 128)')
    levels, feats, rows, _ = table.shape
    _check_idx(name, idx, levels)
    _kernels.require_cuda(name, idx, table,
                          dtypes=(torch.int32, torch.float32))
    m = idx.shape[1]
    out = table.new_empty((levels, feats, m))
    code = _kernels.load_library().nerficg_seg_gather(
        idx.data_ptr(), table.data_ptr(), out.data_ptr(), levels, feats, m,
        rows, _kernels.stream_of(table))
    _kernels.check(code, name)
    seg_gather.launches += 1
    return out


def seg_scatter_add(idx: torch.Tensor, g: torch.Tensor,
                    rows: int) -> torch.Tensor:
    """(L, F, rows, 128) scatter-add into zeros; CUDA tensors launch the
    kernel, CPU tensors take ``seg_scatter_add_plain``."""
    if g.is_cpu:
        return seg_scatter_add_plain(idx, g, rows)
    name = 'seg_scatter_add'
    if g.ndim != 3:
        raise KernelError(f'{name}: g must be (L, F, M)')
    levels, feats, m = g.shape
    _check_idx(name, idx, levels)
    if idx.shape[1] != m:
        raise KernelError(f'{name}: idx and g disagree on M')
    _kernels.require_cuda(name, idx, g, dtypes=(torch.int32, torch.float32))
    out = g.new_empty((levels, feats, rows, LANES))
    code = _kernels.load_library().nerficg_seg_scatter_add(
        idx.data_ptr(), g.data_ptr(), out.data_ptr(), levels, feats, m,
        rows, _kernels.stream_of(g))
    _kernels.check(code, name)
    seg_scatter_add.launches += 1
    return out


seg_gather.launches = 0
seg_scatter_add.launches = 0


class _GatherD(torch.autograd.Function):

    @staticmethod
    def forward(ctx, idx, table):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[2]
        return seg_gather(idx, table)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return None, seg_scatter_add(idx, g.contiguous(), ctx.rows)


class _ScatterAddD(torch.autograd.Function):

    @staticmethod
    def forward(ctx, idx, g, rows):
        ctx.save_for_backward(idx)
        return seg_scatter_add(idx, g, rows)

    @staticmethod
    def backward(ctx, cot):
        (idx,) = ctx.saved_tensors
        return None, seg_gather(idx, cot.contiguous()), None


def gather_d(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Differentiable ``seg_gather`` (gradient to ``table``)."""
    return _GatherD.apply(idx, table)


def scatter_add_d(idx: torch.Tensor, g: torch.Tensor,
                  rows: int) -> torch.Tensor:
    """Differentiable ``seg_scatter_add`` (gradient to ``g``)."""
    return _ScatterAddD.apply(idx, g, rows)
