"""Differentiable tile rasterization of projected Gaussians.

Port of nerficg_tpu/ops/gs_rasterize.py ``rasterize_gaussians`` (:237-366):
each visible Gaussian is duplicated into a fixed number D of (tile, depth)
entries covering its pixel rect (linearized rect cover plus an exact
circle-vs-tile cull), the entries are sorted by (tile, depth), and each tile
composites its segment of the sorted, channel-major stream
(``ops/gs_tiles_kernel.composite_sorted``, the CUDA kernels #15/#16).

The entry order is the JAX package's, exactly: the same keys over the same
flat (D, N) order, sorted stably (``jax.lax.sort`` is stable). Serving
sorts on one fused key whose depth keeps only the top 32 - bit_length(T+1)
bits of the depth's f32 pattern (19 at 1080p), so ties are common there and
their order decides the composite. The sort and the segment search are
plain PyTorch, as they are XLA ops in the JAX package; the 16-wide stream
is written from the Gaussians by ``ops/gs_gather.stream_gather`` (on the
card the kernel pair of ``csrc/gs_gather.cu``, whose backward reads only
the entries the compositor keeps), the packed one gathered in PyTorch.
``rasterize_gaussians`` opens the ``rasterizer`` span, the compositor's
call the ``composite`` span, and it counts ``gs/entries``,
``gs/entries_past_k`` and ``gs/gaussians_past_d`` (``core/tracing.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nerficg_torch.core.tracing import count, span, traced
from nerficg_torch.ops.gs_gather import stream_gather
from nerficg_torch.ops.gs_tiles_kernel import (MEANS_FP_BIAS, MEANS_FP_SCALE,
                                               TILE, _as_f32,
                                               composite_sorted)

__all__ = ['rasterize_gaussians', 'entry_stream', 'TILE']


def _tile_cell(v: torch.Tensor, hi: int) -> torch.Tensor:
    """floor(v / TILE) as int32 clipped to [0, hi]; the float floor division
    of the JAX package (:263-270), exact for a power-of-two tile."""
    cell = torch.div(v, TILE, rounding_mode='floor')
    cell = torch.clamp(cell, -2.0 ** 30, 2.0 ** 30)
    return torch.clamp(cell.to(torch.int32), 0, hi)


def _segments(sorted_tile: torch.Tensor, num_tiles: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(starts, counts) (T,) int32 by binary search over the sorted tiles."""
    edges = torch.searchsorted(
        sorted_tile, torch.arange(num_tiles + 1, dtype=torch.int32,
                                  device=sorted_tile.device), side='left')
    return edges[:-1].to(torch.int32), (edges[1:] - edges[:-1]).to(
        torch.int32)


def _sort_entries_packed(means2d, conics, opacities, colors, depths,
                         tile_of_entry, ent_tx, ent_ty, num_tiles):
    """Serving sort (:134-196): one fused u32 key (tile high bits | top bits
    of the positive f32 depth) and 5 packed payload words: tile-relative
    u16.u16 fixed-point means and bf16 pairs ca|cb, cc|op, r|g, b|d. The
    u32 words are held in int64. Returns ((5, E) f32 bit patterns, starts,
    counts)."""
    tile_bits = int(num_tiles + 1).bit_length()
    depth_bits = 32 - tile_bits
    dep_u = (depths.contiguous().view(torch.int32).long() & 0xFFFFFFFF) >> (
        32 - depth_bits)
    key = ((tile_of_entry.long() << depth_bits) | dep_u[None, :]).reshape(-1)
    span = MEANS_FP_BIAS * MEANS_FP_SCALE

    def fixed(mean, cell):
        q = torch.round((mean[None, :] - cell.float() * TILE) *
                        MEANS_FP_SCALE + span)
        return torch.clamp(q, 0.0, 65535.0).long()

    mxy = ((fixed(means2d[:, 0], ent_tx) << 16) |
           fixed(means2d[:, 1], ent_ty)).reshape(-1)

    def bf16(a):
        return a.to(torch.bfloat16).view(torch.int16).long() & 0xFFFF

    dup = tile_of_entry.shape[0]

    def pair(a, b):
        word = (bf16(a) << 16) | bf16(b)
        return word[None, :].expand(dup, -1).reshape(-1)

    words = torch.stack([mxy, pair(conics[:, 0], conics[:, 1]),
                         pair(conics[:, 2], opacities),
                         pair(colors[:, 0], colors[:, 1]),
                         pair(colors[:, 2], depths)])
    order = torch.sort(key, stable=True).indices
    starts, counts = _segments((key[order] >> depth_bits).to(torch.int32),
                               num_tiles)
    return _as_f32(words[:, order]), starts, counts


def _tile_depth_key(tile: torch.Tensor, depth: torch.Tensor
                    ) -> torch.Tensor:
    """int64 key (tile << 32) | u32(depth) that orders entries by (tile,
    depth) as ``jax.lax.sort`` does (``_permute_entries`` :199): the f32
    bits of the depth (-0 made +0, which lax.sort calls equal) with the
    magnitude flipped under a set sign, offset by 2^31, order like the
    values."""
    depth = torch.where(depth == 0, torch.zeros_like(depth), depth)
    bits = depth.contiguous().view(torch.int32).long()
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits) + 2 ** 31
    return (tile.long() << 32) | ordered


def _assemble_tiles(out: torch.Tensor, width: int, height: int,
                    background: torch.Tensor) -> dict:
    """(T, 5, P) per-tile composites -> rgb/alpha/depth HxWxC (:371-390)."""
    tiles_x = -(-width // TILE)
    tiles_y = -(-height // TILE)

    def to_image(tile_data, chs):
        img = tile_data.reshape(tiles_y, tiles_x, TILE, TILE, chs)
        img = img.permute(0, 2, 1, 3, 4).reshape(tiles_y * TILE,
                                                 tiles_x * TILE, chs)
        return img[:height, :width]

    image = to_image(out[:, 0:3].transpose(1, 2), 3)
    alpha = to_image(out[:, 3, :, None], 1)
    depth = to_image(out[:, 4, :, None], 1) / torch.clamp(alpha, min=1e-10)
    image = image + (1.0 - alpha) * background.to(image.dtype)
    return {'rgb': image, 'alpha': alpha, 'depth': depth}


def entry_stream(means2d: torch.Tensor, depths: torch.Tensor,
                 conics: torch.Tensor, radii: torch.Tensor,
                 colors: torch.Tensor, opacities: torch.Tensor,
                 visible: torch.Tensor, width: int, height: int,
                 max_tiles_per_gaussian: int = 9, max_per_tile: int = 256,
                 packed_inference: bool = False) -> dict:
    """The (tile, depth)-sorted channel-major stream the compositor reads:
    {'sorted_mat' (16 or 8, E_pad), 'starts', 'counts' (T,) int32,
    'tiles_x', 'num_tiles', 'overflow_gaussians' (rects larger than D
    tiles)}; inputs as ``rasterize_gaussians``."""
    k = max_per_tile
    tiles_x = -(-width // TILE)
    tiles_y = -(-height // TILE)
    num_tiles = tiles_x * tiles_y
    device = means2d.device

    m2d = means2d.detach()
    rad = radii.detach()
    t_min_x = _tile_cell(m2d[:, 0] - rad, tiles_x - 1)
    t_max_x = _tile_cell(m2d[:, 0] + rad, tiles_x - 1)
    t_min_y = _tile_cell(m2d[:, 1] - rad, tiles_y - 1)
    t_max_y = _tile_cell(m2d[:, 1] + rad, tiles_y - 1)
    # Linearized rect cover (:271-284): entry j of a Gaussian with rect
    # (w, h) covers tile (min_x + j % w, min_y + j // w); (D, N) layout.
    rect_w = t_max_x - t_min_x + 1
    j = torch.arange(max_tiles_per_gaussian, dtype=torch.int32,
                     device=device)[:, None]
    tx = t_min_x[None, :] + j % rect_w[None, :]
    ty = t_min_y[None, :] + torch.div(j, rect_w[None, :],
                                      rounding_mode='floor')
    dup_valid = (tx <= t_max_x[None, :]) & (ty <= t_max_y[None, :]) & \
        visible[None, :] & (rad[None, :] > 0)
    # Exact circle-vs-tile cull (:285-295).
    x0 = tx.float() * TILE
    y0 = ty.float() * TILE
    cpx = torch.minimum(torch.maximum(m2d[None, :, 0], x0), x0 + TILE)
    cpy = torch.minimum(torch.maximum(m2d[None, :, 1], y0), y0 + TILE)
    dcx = cpx - m2d[None, :, 0]
    dcy = cpy - m2d[None, :, 1]
    dup_valid &= (dcx * dcx + dcy * dcy) <= (rad * rad)[None, :]
    tile_of_entry = torch.where(dup_valid, ty * tiles_x + tx,
                                torch.full_like(tx, num_tiles))

    e = tile_of_entry.numel()
    e_pad = -(-(e + 3 * k) // k) * k
    if packed_inference:
        sorted_ch, starts, counts = _sort_entries_packed(
            m2d, conics, opacities, colors, depths, tile_of_entry, tx, ty,
            num_tiles)
        sorted_mat = F.pad(sorted_ch, (0, e_pad - e, 0,
                                       8 - sorted_ch.shape[0]))
    else:
        dup = tile_of_entry.shape[0]
        entry_tile = tile_of_entry.reshape(-1)
        entry_depth = depths.detach()[None, :].expand(dup, -1).reshape(-1)
        # One stable sort: ties in input order, as jax.lax.sort's.
        perm = torch.sort(_tile_depth_key(entry_tile, entry_depth),
                          stable=True).indices
        sorted_tile = entry_tile[perm]
        starts, counts = _segments(sorted_tile, num_tiles)
        sorted_mat = stream_gather(means2d, conics, opacities, colors,
                                   depths, perm, sorted_tile, starts, k,
                                   e_pad)
    rect_h = t_max_y - t_min_y + 1
    return {'sorted_mat': sorted_mat,
            'starts': starts, 'counts': counts,
            'tiles_x': tiles_x, 'num_tiles': num_tiles,
            'overflow_gaussians': ((rect_w * rect_h > max_tiles_per_gaussian)
                                   & visible & (rad > 0)).sum()}


@traced('rasterizer')
def rasterize_gaussians(means2d: torch.Tensor, depths: torch.Tensor,
                        conics: torch.Tensor, radii: torch.Tensor,
                        colors: torch.Tensor, opacities: torch.Tensor,
                        visible: torch.Tensor, width: int, height: int,
                        background: torch.Tensor,
                        max_tiles_per_gaussian: int = 9,
                        max_per_tile: int = 256,
                        packed_inference: bool = False) -> dict:
    """means2d (N, 2), depths (N,), conics (N, 3), radii (N,), colors
    (N, 3), opacities (N,), visible (N,) -> {'rgb', 'alpha', 'depth'} HxWxC
    plus the truncation counters 'overflow_gaussians' (rects larger than D
    tiles) and 'overflow_entries' (entries past a tile's budget k), and the
    tiles' entry 'counts'. Differentiable in means2d, conics, colors,
    opacities and depths unless ``packed_inference``."""
    stream = entry_stream(means2d, depths, conics, radii, colors, opacities,
                          visible, width, height, max_tiles_per_gaussian,
                          max_per_tile, packed_inference)
    counts = stream['counts']
    with span('composite'):
        out = composite_sorted(stream['sorted_mat'], stream['starts'],
                               counts, stream['tiles_x'],
                               stream['num_tiles'], max_per_tile)
    result = _assemble_tiles(out, width, height, background)
    result['overflow_gaussians'] = stream['overflow_gaussians']
    result['overflow_entries'] = torch.clamp(counts - max_per_tile,
                                             min=0).sum()
    result['counts'] = counts
    count('gs/entries', counts)
    count('gs/entries_past_k', result['overflow_entries'])
    count('gs/gaussians_past_d', result['overflow_gaussians'])
    return result
