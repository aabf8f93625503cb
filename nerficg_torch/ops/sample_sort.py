"""Block permutation between the marcher's morton order and ray order,
ported from nerficg_tpu/ops/sample_sort.py.

The field runs on the morton-ordered sample stream; its outputs return to
ray order as whole blocks, a row permutation ``mat[perm]`` of a (blocks,
channels * block) matrix. Its gradient is the inverse permutation: with
``perm_inv`` given, the backward gathers ``g[perm_inv]`` as the JAX VJP does
(a gather, no scatter); without it, autograd of the indexing scatters.
"""

from __future__ import annotations

import torch

__all__ = ['permute_block_channels']


class _Permute(torch.autograd.Function):
    """out = mat[perm]; backward d_mat = g[perm_inv] (perm a bijection)."""

    @staticmethod
    def forward(ctx, mat, perm, perm_inv):
        ctx.save_for_backward(perm_inv)
        return mat[perm]

    @staticmethod
    def backward(ctx, g):
        (perm_inv,) = ctx.saved_tensors
        return g[perm_inv], None, None


def permute_block_channels(channels: torch.Tensor, block: int,
                           perm: torch.Tensor,
                           perm_inv: torch.Tensor) -> torch.Tensor:
    """Reorder per-sample channels (C, B) by a BLOCK permutation.

    channels: (C, B) with B = num_blocks * block, blocks contiguous.
    perm: (B/block,) block permutation (march.perm_to_ray for morton->ray);
    output block i is input block perm[i]. perm_inv: its inverse
    (march.perm_to_morton). Differentiable in ``channels``."""
    c, b = channels.shape
    bb = b // block
    mat = channels.reshape(c, bb, block).permute(1, 0, 2).reshape(bb, c * block)
    out = _Permute.apply(mat, perm, perm_inv)
    return out.reshape(bb, c, block).permute(1, 0, 2).reshape(c, b)
