"""30-bit Morton codes of positions, for the memory-coherent order of baked
Gaussians. Port of the 30-bit path of nerficg_tpu/ops/morton.py
``morton_encode_positions`` (:70-89; reference:
CudaUtils/MortonEncoding/morton_encoding.cu:15-76, whose 63-bit codes the
JAX package uses only with x64 enabled). Elementwise integer PyTorch."""

from __future__ import annotations

import torch

__all__ = ['morton3d', 'morton_encode_positions']


def _expand_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every third bit (uint32 arithmetic in int64)."""
    v = v.long() & 0x3FF
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(coords: torch.Tensor) -> torch.Tensor:
    """(..., 3) int grid coords (< 1024 per axis) -> (...,) 30-bit codes."""
    return _expand_bits_10(coords[..., 0]) | \
        (_expand_bits_10(coords[..., 1]) << 1) | \
        (_expand_bits_10(coords[..., 2]) << 2)


def morton_encode_positions(positions: torch.Tensor,
                            aabb_min: torch.Tensor,
                            aabb_max: torch.Tensor) -> torch.Tensor:
    """(N, 3) f32 positions -> (N,) int64 30-bit Morton codes of their
    1024^3 cells in the box."""
    norm = (positions - aabb_min) / torch.clamp(aabb_max - aabb_min,
                                                min=1e-12)
    norm = torch.clamp(norm, 0.0, 1.0 - 1e-7)
    return morton3d((norm * 1024.0).to(torch.int32))
