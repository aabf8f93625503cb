"""Block permutation between the marcher's morton order and ray order,
ported from nerficg_tpu/ops/sample_sort.py (forward only: rendering routes
field outputs back to ray order and needs no gradient)."""

from __future__ import annotations

import torch

__all__ = ['permute_block_channels']


def permute_block_channels(channels: torch.Tensor, block: int,
                           perm: torch.Tensor) -> torch.Tensor:
    """Reorder per-sample channels (C, B) by a BLOCK permutation.

    channels: (C, B) with B = num_blocks * block, blocks contiguous.
    perm: (B/block,) block permutation (march.perm_to_ray for morton->ray);
    output block i is input block perm[i]."""
    c, b = channels.shape
    bb = b // block
    mat = channels.reshape(c, bb, block).permute(1, 0, 2).reshape(bb, c * block)
    out = mat[perm]
    return out.reshape(bb, c, block).permute(1, 0, 2).reshape(c, b)
