"""32-bit counter hashes shared by the kernels and their plain versions.

The TPU kernels draw stochastic-corner bits with ``pltpu.prng_random_bits``,
a generator the TPU alone has. The port keys its own counter-based generator
by (seed, level, sample index, dimension): one 32-bit word is

    key  = mix32(seed ^ ((level * 3 + dim + 1) * 0x9E3779B9))
    word = mix32(sample_index ^ key)

with ``mix32`` the "lowbias32" finalizer (xorshift-multiply, two rounds).
``nerficg_torch/csrc/hash_window.cu`` computes the same words in
``uint32_t``; here they are int64 tensors holding uint32 values, and every
product is taken modulo 2^32 without overflowing int64 (``mul32``), so the
kernel and the plain version draw identical corners.
"""

from __future__ import annotations

import torch

__all__ = ['M32', 'mul32', 'mix32', 'stream_key', 'corner_bits']

M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_MIX1 = 0x7FEB352D
_MIX2 = 0x846CA68B


def mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32) (int64 tensor or int), split
    into 16-bit halves of ``c`` so that no product exceeds 2^49."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def mix32(x):
    """lowbias32 finalizer on uint32 values held in int64 (or a Python int)."""
    x = x ^ (x >> 16)
    x = mul32(x, _MIX1)
    x = x ^ (x >> 15)
    x = mul32(x, _MIX2)
    return x ^ (x >> 16)


def stream_key(seed: int, level: int, dim: int) -> int:
    """Per (seed, level, dimension) key of the corner-bit stream."""
    return mix32((int(seed) & M32) ^ mul32(level * 3 + dim + 1, _GOLDEN))


def corner_bits(seed: int, level: int, index: torch.Tensor,
                dim: int) -> torch.Tensor:
    """uint32 words (in int64) for sample indices ``index`` (int64)."""
    return mix32(index ^ stream_key(seed, level, dim))
