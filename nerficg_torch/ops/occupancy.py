"""Occupancy-grid ray marching with static-budget sample compaction,
front-to-back compositing on the compacted layout, and the density-grid
update, ported from nerficg_tpu/ops/occupancy.py (:62-73, :126-573,
:580-665, :745-760).

The marcher probes a fixed number of candidate points per block of
``block`` steps against the two-level block bitfield, compacts the occupied
blocks into a static sample budget with one stable sort of their morton keys
(which also yields the morton-ordered stream the windowed hash encode
wants), and expands them back into samples in ray order and in morton
order. ``composite_packed`` blends the ray-ordered samples with per-block
prefix sums, a scatter of each ray's prefix offset and a gather back, and
one 5-channel per-ray scatter (the segment kernels of ops/hash_mxu.py, in
their differentiable forms). Training samples are jittered along the ray by
a counter hash of their flat (ray, step) index (``_hash_jitter``).

Both sorts are stable, as ``jax.lax.sort`` is: equal morton keys keep their
block order, which fixes the compaction when the budget truncates.

The renderer's block probes (``occupancy_probe_block_cascaded_xyz`` and
``occupancy_probe_block_aabb_xyz``) go through ``block_probe_xyz``: on
CUDA tensors one launch of the kernel of csrc/block_probe.cu that
computes the cells from the world planes in registers, bit for bit as the
plain composition computes them; on CPU tensors that composition. The
dense probes (PROBE_MODE 'dense': ``occupancy_probe_cascaded_xyz`` on
(C, words, 128) bitfields, or, without a ``probe_fn``, the marcher's own
``occupancy_probe_xyz`` on one (words, 128) bitfield) compute their cells
in PyTorch and gather the words through ``xbar_gather``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from nerficg_torch.core.errors import KernelError
from nerficg_torch.ops import _kernels
from nerficg_torch.ops.counter_rng import M32, mul32
from nerficg_torch.ops.hash_mxu import gather_d, scatter_add_d
from nerficg_torch.ops.hash_window import morton_keys_xyz
from nerficg_torch.ops.ray_aabb import ray_aabb_intersect
from nerficg_torch.ops.xbar_gather import (block_probe_cells,
                                           block_probe_cells_plain,
                                           block_table_rows,
                                           build_block_bitfield,
                                           occupancy_probe_xyz, pack_bits,
                                           probe_packed_bits)

__all__ = ['MarchResults', 'march_rays', 'composite_packed', 'GridDraws',
           'draw_grid_update', 'update_density_grid',
           'downsample_occupancy', 'downsample_occupancy_cascaded',
           'downsample_occupancy_block', 'downsample_occupancy_cascaded_block',
           'occupancy_probe_block_xyz', 'occupancy_probe_block_cascaded_xyz',
           'occupancy_probe_block_cascaded_xyz_plain',
           'occupancy_probe_block_aabb_xyz',
           'occupancy_probe_block_aabb_xyz_plain', 'block_probe_xyz',
           'num_cascades', 'cascade_of_positions',
           'occupancy_probe_cascaded_xyz', 'occupancy_probe_cascaded',
           'cascade_cell_positions']


class MarchResults(NamedTuple):
    """Compacted samples (all static-shaped to the budget B = Bb * block)."""
    positions: torch.Tensor    # (B, 3) world-space sample positions
    directions: torch.Tensor   # (B, 3) per-sample ray directions
    ts: torch.Tensor           # (B,) depth along ray
    deltas: torch.Tensor       # (B,) step size
    ray_ids: torch.Tensor      # (B,) owning ray (== num_rays for padding)
    valid: torch.Tensor        # (B,) bool validity
    num_valid: torch.Tensor    # () number of real samples
    ray_complete: torch.Tensor  # (R,) bool: ray's samples all fit the budget
    num_blocks: torch.Tensor   # () occupied blocks over the whole batch
    # Morton-ordered view for the windowed encode (``morton=True``).
    positions_m: Optional[torch.Tensor] = None   # (B, 3)
    directions_m: Optional[torch.Tensor] = None  # (B, 3)
    ray_ids_m: Optional[torch.Tensor] = None     # (B,)
    perm_to_ray: Optional[torch.Tensor] = None   # (Bb,) morton slot of block i
    perm_to_morton: Optional[torch.Tensor] = None  # (Bb,) block at morton slot
    block_keys_m: Optional[torch.Tensor] = None  # (Bb,) sorted block keys


def _hash_jitter(flat_ids: torch.Tensor, seed: int) -> torch.Tensor:
    """Per-sample jitter in [0, 1) from a counter hash of the flat sample
    index (uint32 arithmetic in int64)."""
    h = mul32(flat_ids & M32, 2654435761) ^ (int(seed) & M32)
    h = h ^ (h >> 16)
    h = mul32(h, 0x45D9F3B)
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) / 16777216.0


def march_rays(origins: torch.Tensor, directions: torch.Tensor,
               aabb_min: torch.Tensor, aabb_max: torch.Tensor,
               probe_fn: Optional[Callable[[torch.Tensor, torch.Tensor,
                                            torch.Tensor], torch.Tensor]],
               max_steps: int, sample_budget: int, min_near: float = 0.05,
               block: int = 32, exponential: bool = False,
               morton: bool = False,
               probes_per_block: int = 2,
               seed: Optional[int] = None,
               grid_binary: Optional[torch.Tensor] = None,
               grid_resolution: int = 0) -> MarchResults:
    """Fixed-step occupancy-skipping ray marcher (replaces CUDA N4).

    origins/directions: (R, 3), directions unit-norm. ``probe_fn`` maps
    per-axis world-coordinate planes to occupancy; without one, the
    samples' unit coordinates in the box are probed in ``grid_binary``, a
    (words, 128) ``pack_bits`` bitfield of the flat (res^3,) flags at
    ``grid_resolution`` (``occupancy_probe_xyz``, the JAX marcher's
    default). ``seed`` (uint32) jitters
    each sample within its step (training; the JAX marcher's
    ``jax.random.bits(rng, uint32)``); without it samples sit at step
    midpoints. ``exponential``: geometric step spacing for multi-cascade
    scenes. Returns compacted samples with a static budget.
    """
    if probe_fn is None and (grid_binary is None or grid_binary.ndim != 2):
        raise ValueError('march_rays needs a probe_fn or a (words, 128) '
                         'grid_binary')

    def probe_at(px, py, pz, ux, uy, uz):
        if probe_fn is not None:
            return probe_fn(px, py, pz)
        return occupancy_probe_xyz(grid_binary, ux, uy, uz, grid_resolution)

    num_rays = origins.shape[0]
    device = origins.device
    block = min(block, max_steps)
    if max_steps % block:
        raise ValueError('max_steps must divide by the block size')
    sample_budget = -(-sample_budget // block) * block
    t_near, t_far = ray_aabb_intersect(origins, directions, aabb_min,
                                       aabb_max, min_near)
    # Degenerate (zero) directions come from batch padding: misses.
    nonzero_dir = (directions * directions).sum(-1) > 1e-12
    hit = (t_near < t_far) & nonzero_dir
    t_far = torch.where(hit, t_far, t_near + 1.0)
    if exponential:
        rate = torch.log(torch.clamp(t_far / t_near, min=1.0 + 1e-6)) \
            / max_steps
    else:
        rate = (t_far - t_near) / max_steps

    # --- block-level candidate pass ---------------------------------------
    blocks_per_ray = max_steps // block
    nblocks = num_rays * blocks_per_ray
    block_budget = sample_budget // block
    pfrac = (torch.arange(probes_per_block, dtype=torch.float32,
                          device=device) + 0.5) / probes_per_block
    bidx = torch.arange(blocks_per_ray, dtype=torch.float32, device=device)
    step_pos = ((bidx[:, None] + pfrac[None, :]) * block).reshape(-1)
    if exponential:
        ts_p = t_near[:, None] * torch.exp(step_pos[None] * rate[:, None])
    else:
        ts_p = t_near[:, None] + step_pos[None] * rate[:, None]
    px = origins[:, 0:1] + directions[:, 0:1] * ts_p
    py = origins[:, 1:2] + directions[:, 1:2] * ts_p
    pz = origins[:, 2:3] + directions[:, 2:3] * ts_p
    ext = aabb_max - aabb_min
    ux = (px - aabb_min[0]) / ext[0]
    uy = (py - aabb_min[1]) / ext[1]
    uz = (pz - aabb_min[2]) / ext[2]
    in_box = ((ux >= 0.0) & (ux < 1.0) & (uy >= 0.0) & (uy < 1.0) &
              (uz >= 0.0) & (uz < 1.0))
    occupied = probe_at(px, py, pz, ux, uy, uz)
    block_any2 = (occupied & in_box).reshape(
        num_rays, blocks_per_ray, probes_per_block).any(2) & hit[:, None]

    # --- block compaction: one stable masked-morton sort ------------------
    pstride = probes_per_block
    hi = 1.0 - 1e-6
    bkeys = morton_keys_xyz(torch.clamp(ux[:, ::pstride], 0.0, hi),
                            torch.clamp(uy[:, ::pstride], 0.0, hi),
                            torch.clamp(uz[:, ::pstride], 0.0, hi))
    inf = 1 << 30
    key_flat = torch.where(block_any2, bkeys, inf).reshape(-1)
    k_sorted, blk_sorted = torch.sort(key_flat, stable=True)
    take = min(block_budget, nblocks)
    pad_b = block_budget - take
    pad = torch.nn.functional.pad
    block_sel_m = pad(blk_sorted[:take], (0, pad_b))          # morton order
    block_valid_m = pad(k_sorted[:take] < inf, (0, pad_b))
    # Padding blocks expand at the last valid block's geometry, so the
    # morton tail stays spatially tight for the windowed encode.
    nvalid_b = block_any2.sum()
    last = torch.clamp(nvalid_b - 1, 0, nblocks - 1)
    last_valid = blk_sorted[last]
    safe_block_m = torch.where(block_valid_m, block_sel_m, last_valid)
    # ray-major view (ascending block index)
    ray_key = torch.where(block_valid_m, block_sel_m, nblocks)
    rk_sorted, perm_to_ray = torch.sort(ray_key, stable=True)
    blk_ray = block_sel_m[perm_to_ray]
    block_valid = rk_sorted < nblocks
    safe_block = torch.where(block_valid, blk_ray, 0)

    ray_table = torch.stack([t_near, rate, origins[:, 0], origins[:, 1],
                             origins[:, 2], directions[:, 0], directions[:, 1],
                             directions[:, 2]], dim=1)          # (R, 8)

    def _expand(safe_blk, blk_valid, probe=True):
        """Blocks -> samples: positions/ts/deltas/dirs/validity."""
        ray_of_block = safe_blk // blocks_per_ray
        block_in_ray = safe_blk - ray_of_block * blocks_per_ray
        fetched = ray_table[ray_of_block]                      # (Bb, 8)
        b_tnear, b_rate = fetched[:, 0], fetched[:, 1]
        offs = torch.arange(block, device=device)[None]
        step_id = block_in_ray[:, None] * block + offs
        sample_step = step_id.float()
        # Training jitters each sample within its step; rendering takes the
        # step midpoint.
        s_jitter = 0.5 if seed is None else _hash_jitter(
            ray_of_block[:, None] * max_steps + step_id, seed)
        if exponential:
            out_ts = b_tnear[:, None] * torch.exp(
                (sample_step + s_jitter) * b_rate[:, None])
            out_dt = out_ts * (torch.exp(b_rate[:, None]) - 1.0)
        else:
            out_ts = b_tnear[:, None] + \
                (sample_step + s_jitter) * b_rate[:, None]
            out_dt = b_rate[:, None].expand(out_ts.shape)
        spx = fetched[:, 2:3] + fetched[:, 5:6] * out_ts
        spy = fetched[:, 3:4] + fetched[:, 6:7] * out_ts
        spz = fetched[:, 4:5] + fetched[:, 7:8] * out_ts
        if probe:
            # Per-sample validity: re-probe the expanded samples so that
            # partially filled blocks are masked.
            sux = (spx - aabb_min[0]) / ext[0]
            suy = (spy - aabb_min[1]) / ext[1]
            suz = (spz - aabb_min[2]) / ext[2]
            in_box_s = ((sux >= 0.0) & (sux < 1.0) & (suy >= 0.0) &
                        (suy < 1.0) & (suz >= 0.0) & (suz < 1.0))
            valid_s = probe_at(spx, spy, spz, sux, suy, suz) & in_box_s & \
                blk_valid[:, None]
        else:
            valid_s = blk_valid[:, None].expand(safe_blk.shape[0], block)
        out_pos = torch.stack([spx, spy, spz], dim=-1)         # (Bb, blk, 3)
        out_dirs = fetched[:, None, 5:8].expand(out_pos.shape).reshape(-1, 3)
        return (out_pos.reshape(-1, 3), out_dirs, out_ts.reshape(-1),
                out_dt.reshape(-1), ray_of_block, valid_s)

    out_pos, out_dirs, out_ts, out_dt, ray_of_block, valid2 = _expand(
        safe_block, block_valid)
    valid = valid2.reshape(-1)
    ray_ids = ray_of_block[:, None].expand(valid2.shape).reshape(-1)
    num_valid = valid.sum()
    # A ray is complete iff the running count of occupied blocks up to its
    # end fits the budget.
    cum_blocks = torch.cumsum(block_any2.sum(1), 0)
    ray_complete = cum_blocks <= block_budget
    num_blocks = cum_blocks[-1]
    # Only samples of PADDING blocks go to the drop segment R; in-block
    # invalid samples keep their ray id (their alpha is masked to zero).
    pad_samples = block_valid[:, None].expand(block_budget, block).reshape(-1)
    ray_ids = torch.where(pad_samples, ray_ids, num_rays)

    extras = {}
    if morton:
        perm_to_morton = torch.empty_like(perm_to_ray)
        perm_to_morton[perm_to_ray] = torch.arange(
            block_budget, dtype=perm_to_ray.dtype, device=device)
        pos_m, dirs_m, _, _, ray_of_block_m, _ = _expand(
            safe_block_m, block_valid_m, probe=False)
        ray_ids_m = ray_of_block_m[:, None].expand(
            block_budget, block).reshape(-1)
        # Anchor keys for the windowed encode: the invalid tail repeats the
        # last valid key, so the sequence stays monotone.
        keys_taken = pad(k_sorted[:take], (0, pad_b))
        block_keys_m = torch.where(block_valid_m, keys_taken, k_sorted[last])
        extras = dict(positions_m=pos_m, directions_m=dirs_m,
                      ray_ids_m=ray_ids_m, perm_to_ray=perm_to_ray,
                      perm_to_morton=perm_to_morton,
                      block_keys_m=block_keys_m)

    return MarchResults(positions=out_pos, directions=out_dirs, ts=out_ts,
                        deltas=out_dt, ray_ids=ray_ids, valid=valid,
                        num_valid=num_valid, ray_complete=ray_complete,
                        num_blocks=num_blocks, **extras)


def composite_packed(densities: torch.Tensor, rgbs: torch.Tensor,
                     march: MarchResults, num_rays: int,
                     background: Optional[torch.Tensor] = None,
                     early_stop_eps: float = 1e-4,
                     block: int = 8) -> dict:
    """Front-to-back compositing on the compacted layout (replaces CUDA
    N6/N7; nerficg_tpu/ops/occupancy.py:392-493).

    densities: (B,); rgbs: (B, 3) or channel-major (3, B). Samples of a ray
    are contiguous and depth-ordered. The exclusive transmittance per sample
    is exp of a global prefix sum of log(1 - alpha) minus the prefix at the
    ray's first sample; all segment reductions run at block granularity."""
    b_total = densities.shape[0]
    if block > 1 and b_total % block != 0:
        block = 1
    if rgbs.shape[0] == 3 and rgbs.shape[-1] == b_total and b_total != 3:
        rgb_r, rgb_g, rgb_b = rgbs[0], rgbs[1], rgbs[2]
    else:
        rgb_r, rgb_g, rgb_b = rgbs[:, 0], rgbs[:, 1], rgbs[:, 2]

    alpha = 1.0 - torch.exp(-densities * march.deltas)
    alpha = torch.where(march.valid, alpha, 0.0)
    log_t = torch.log1p(-torch.clamp(alpha, 0.0, 1.0 - 1e-7))   # (B,) <= 0

    # Segments padded to a lane multiple; padding rays land in segment
    # ``num_rays`` and are dropped.
    seg_pad = ((num_rays + 1 + 127) // 128) * 128
    seg_rows = seg_pad // 128

    if block > 1:
        nb = b_total // block
        lt2 = log_t.reshape(nb, block)
        csum_in = torch.cumsum(lt2, 1)                           # within-block
        block_total = csum_in[:, -1]
        block_excl = torch.cumsum(block_total, 0) - block_total
        excl = (block_excl[:, None] + csum_in - lt2).reshape(-1)
        ray_of_block = march.ray_ids.reshape(nb, block)[:, 0]
        first_vals = block_excl
    else:
        csum = torch.cumsum(log_t, 0)
        excl = csum - log_t
        ray_of_block = march.ray_ids
        first_vals = excl
    seg_ids = ray_of_block.to(torch.int32)[None].contiguous()   # (1, Bb)
    prev_ids = torch.cat([torch.full_like(ray_of_block[:1], -1),
                          ray_of_block[:-1]])
    is_first = (ray_of_block != prev_ids).to(excl.dtype)
    offsets = scatter_add_d(seg_ids, (first_vals * is_first)[None, None],
                            seg_rows)
    offset_b = gather_d(seg_ids, offsets)[0, 0]                   # (Bb,)
    offset_per_sample = offset_b.repeat_interleave(block) if block > 1 \
        else offset_b

    # Padding samples can carry garbage offsets: clamp the exponent.
    trans = torch.exp(torch.clamp(excl - offset_per_sample, max=0.0))
    trans = torch.where(march.valid, trans, 0.0)
    weights = trans * alpha
    if early_stop_eps > 0.0:
        # Zero contributions once transmittance is negligible (the CUDA
        # early termination at T <= 1e-4, here a mask).
        weights = torch.where(trans > early_stop_eps, weights, 0.0)

    # One 5-channel segment sum: [rgb, acc, weighted depth].
    channels = torch.stack([weights * rgb_r, weights * rgb_g,
                            weights * rgb_b, weights,
                            weights * march.ts], dim=0)           # (5, B)
    if block > 1:
        channels = channels.reshape(5, b_total // block, block).sum(-1)
    sums = scatter_add_d(seg_ids, channels[None].contiguous(), seg_rows)
    sums = sums.reshape(5, seg_pad)[:, :num_rays]
    rgb = sums[:3].T
    acc = sums[3][:, None]
    depth = sums[4][:, None] / torch.clamp(acc, min=1e-10)
    if background is not None:
        rgb = rgb + (1.0 - acc) * background.to(rgb.dtype)
    return {'rgb': rgb, 'depth': depth, 'alpha': acc, 'weights': weights,
            'sample_ray_ids': march.ray_ids}


# ---------------------------------------------------------------------------
# Density-grid update
# ---------------------------------------------------------------------------

class GridDraws(NamedTuple):
    """The random draws of one density-grid update, made on the host so
    that no update waits on the card (and a test can hand in the draws the
    JAX function makes from its key)."""
    start: int               # uniform slab start cell
    biased: bool             # take the occupancy-weighted start instead
    bin_u: float             # uniform in [0, 1): categorical over the bins
    shift: int               # offset of the weighted start, +-half a slab
    offsets: torch.Tensor    # (num_samples, 3) in-cell offsets in [0, 1)


_GRID_BINS = 256


def draw_grid_update(generator: torch.Generator, total: int,
                     num_samples: int, warmup: bool = False,
                     occupied_bias: float = 0.5) -> GridDraws:
    """All draws of one ``update_density_grid`` call from a CPU generator.
    During warm-up every cell is refreshed."""
    num = total if warmup else min(num_samples, total)
    start = int(torch.randint(0, total, (1,), generator=generator))
    biased, bin_u, shift = False, 0.0, 0
    if occupied_bias > 0.0 and not warmup:
        bin_u = float(torch.rand(1, generator=generator, dtype=torch.float64))
        shift = int(torch.randint(-(num // 2), num // 2 + 1, (1,),
                                  generator=generator))
        biased = float(torch.rand(1, generator=generator)) < occupied_bias
    offsets = torch.rand((num, 3), generator=generator)
    return GridDraws(start, biased, bin_u, shift, offsets)


def update_density_grid(density_grid: torch.Tensor,
                        query_fn: Callable[[torch.Tensor], torch.Tensor],
                        aabb_min: torch.Tensor, aabb_max: torch.Tensor,
                        resolution: int, draws: GridDraws,
                        decay: float = 0.95,
                        position_fn: Optional[Callable] = None,
                        carve_mask: Optional[torch.Tensor] = None,
                        occupied_threshold: float = 0.0) -> torch.Tensor:
    """EMA-decay max-update of a contiguous (circular) slab of the density
    grid (nerficg_tpu/ops/occupancy.py:496-573; reference:
    InstantNGP/Renderer.py:245-272).

    density_grid: (C * res^3,). The slab starts at a uniform cell, or, when
    ``draws.biased``, at a bin drawn with probability proportional to its
    occupied-cell count (+1e-3) plus ``draws.shift``. The slab's cells are
    queried at in-cell ``draws.offsets``; carved cells stay empty. Returns
    the new grid (the old one is not modified)."""
    total = density_grid.shape[0]
    device = density_grid.device
    num = draws.offsets.shape[0]
    if draws.biased:
        bin_size = -(-total // _GRID_BINS)
        padded = torch.nn.functional.pad(density_grid,
                                         (0, _GRID_BINS * bin_size - total))
        occ = (padded > occupied_threshold).reshape(_GRID_BINS, bin_size)
        cdf = torch.cumsum(occ.sum(1).double() + 1e-3, 0)
        chosen = torch.searchsorted(cdf, (draws.bin_u * cdf[-1]).reshape(1),
                                    right=True).clamp(max=_GRID_BINS - 1)
        start = (chosen * bin_size + draws.shift) % total
    else:
        start = draws.start
    cells = (start + torch.arange(num, device=device)) % total
    offsets = draws.offsets.to(device)
    if position_fn is not None:
        positions = position_fn(cells, offsets)
    else:
        z = cells % resolution
        y = (cells // resolution) % resolution
        x = cells // (resolution * resolution)
        unit = (torch.stack([x, y, z], -1).float() + offsets) / resolution
        positions = aabb_min + unit * (aabb_max - aabb_min)
    new_density = query_fn(positions)
    if carve_mask is not None:
        new_density = new_density * carve_mask[cells].to(new_density.dtype)
    grid = density_grid * decay
    grid[cells] = torch.maximum(grid[cells], new_density)
    return grid


# ---------------------------------------------------------------------------
# Occupancy grids: two-level block bitfields over one or more cascades
# ---------------------------------------------------------------------------

def downsample_occupancy(density_grid: torch.Tensor, resolution: int,
                         march_resolution: int,
                         threshold: float) -> torch.Tensor:
    """Max-pool the (res^3,) density grid to the marching resolution and
    pack its flags above ``threshold`` as a (words, 128) int32 bitfield
    (``pack_bits``): a coarse cell is occupied if any of its children is."""
    factor = resolution // march_resolution
    g = density_grid.reshape(march_resolution, factor, march_resolution,
                             factor, march_resolution, factor)
    return pack_bits((g.amax(dim=(1, 3, 5)) > threshold).reshape(-1))


def downsample_occupancy_cascaded(density_grid: torch.Tensor,
                                  resolution: int, march_resolution: int,
                                  threshold: float,
                                  cascades: int) -> torch.Tensor:
    """(C*res^3,) density -> (C, words, 128) bitfields, one per cascade,
    each padded to whole 4096-bit rows by ``pack_bits``."""
    factor = resolution // march_resolution
    g = density_grid.reshape(cascades, march_resolution, factor,
                             march_resolution, factor,
                             march_resolution, factor)
    coarse = g.amax(dim=(2, 4, 6)) > threshold
    return torch.stack([pack_bits(coarse[c].reshape(-1))
                        for c in range(cascades)])


def downsample_occupancy_block(density_grid: torch.Tensor, resolution: int,
                               march_resolution: int, threshold: float,
                               cap_blocks: int) -> torch.Tensor:
    """Max-pool the (res^3,) density grid to the marching resolution and
    pack it as a two-level block bitfield."""
    factor = resolution // march_resolution
    g = density_grid.reshape(march_resolution, factor, march_resolution,
                             factor, march_resolution, factor)
    coarse = g.amax(dim=(1, 3, 5))
    return build_block_bitfield((coarse > threshold).reshape(-1),
                                march_resolution, cap_blocks)


def downsample_occupancy_cascaded_block(density_grid: torch.Tensor,
                                        resolution: int,
                                        march_resolution: int,
                                        threshold: float, cascades: int,
                                        cap_blocks: int) -> torch.Tensor:
    """(C*res^3,) density -> one packed block bitfield over all cascades
    (cascade = grid index; the capacity pool is shared)."""
    factor = resolution // march_resolution
    g = density_grid.reshape(cascades, march_resolution, factor,
                             march_resolution, factor,
                             march_resolution, factor)
    coarse = g.amax(dim=(2, 4, 6)) > threshold
    return build_block_bitfield(coarse.reshape(-1), march_resolution,
                                cap_blocks, num_grids=cascades)


def _cell(u: torch.Tensor, resolution: int) -> torch.Tensor:
    return torch.clamp((u * resolution).to(torch.int32), 0, resolution - 1)


def occupancy_probe_block_xyz(table: torch.Tensor, ux: torch.Tensor,
                              uy: torch.Tensor, uz: torch.Tensor,
                              resolution: int,
                              cap_blocks: int) -> torch.Tensor:
    """Block-bitfield probe from unit-coordinate planes."""
    return block_probe_cells(table, _cell(ux, resolution),
                             _cell(uy, resolution), _cell(uz, resolution),
                             0, resolution, cap_blocks)


def _cascade_cell_coords(px, py, pz, center, max_half, resolution, cascades):
    """World planes -> (cascade, cx, cy, cz) int32 cell coords in the finest
    containing cascade (the NGP mip selection, raymarching.cu mip_from_pos)."""
    rx = px - center[0]
    ry = py - center[1]
    rz = pz - center[2]
    m = torch.maximum(torch.maximum(rx.abs(), ry.abs()), rz.abs())
    base_half = max_half / (2 ** (cascades - 1))
    c = torch.clamp(torch.ceil(torch.log2(torch.clamp(m / base_half, min=1.0))
                               ).to(torch.int32), 0, cascades - 1)
    inv = 1.0 / ((2.0 * base_half) * torch.exp2(c.float()))
    return (c, _cell(rx * inv + 0.5, resolution),
            _cell(ry * inv + 0.5, resolution),
            _cell(rz * inv + 0.5, resolution))


def occupancy_probe_block_cascaded_xyz_plain(
        table: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
        pz: torch.Tensor, center: torch.Tensor, max_half: float,
        resolution: int, cascades: int, cap_blocks: int) -> torch.Tensor:
    """The cascaded probe in plain PyTorch: ``_cascade_cell_coords``, then
    ``block_probe_cells_plain``."""
    c, cx, cy, cz = _cascade_cell_coords(px, py, pz, center, max_half,
                                         resolution, cascades)
    return block_probe_cells_plain(table, cx, cy, cz, c, resolution,
                                   cap_blocks, num_grids=cascades)


def occupancy_probe_block_aabb_xyz_plain(
        table: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
        pz: torch.Tensor, aabb_min: torch.Tensor, aabb_max: torch.Tensor,
        resolution: int, cap_blocks: int) -> torch.Tensor:
    """The single-grid probe in plain PyTorch: the unit coordinates
    ``(p - aabb_min) / (aabb_max - aabb_min)`` per axis (the JAX renderer's
    composition, nerficg_tpu/methods/instant_ngp/renderer.py:178-183), their
    cells, then ``block_probe_cells_plain``."""
    units = [(p - aabb_min[d]) / (aabb_max[d] - aabb_min[d])
             for d, p in enumerate((px, py, pz))]
    return block_probe_cells_plain(table, *(_cell(u, resolution)
                                            for u in units),
                                   0, resolution, cap_blocks)


def block_probe_xyz(table: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                    pz: torch.Tensor, geo0: torch.Tensor, geo1: torch.Tensor,
                    resolution: int, cap_blocks: int, cascades: int,
                    max_half: float = 0.0) -> torch.Tensor:
    """The block-bitfield probe from world-coordinate planes in one launch
    (``nerficg_block_probe_xyz`` of csrc/block_probe.cu, which replaces the
    TPU kernel nerficg_tpu/ops/xbar_gather.py:36 at the marcher's probes):
    cascaded for ``cascades`` > 0 (geo0 = the grid's center, ``max_half``
    its half-extent), else one grid over [geo0, geo1] = [aabb_min,
    aabb_max]. Returns bool of ``px``'s shape.

    CUDA tensors launch the hand-written kernel; CPU tensors take the plain
    composition of the mode."""
    if px.device.type == 'cpu':
        if cascades > 0:
            return occupancy_probe_block_cascaded_xyz_plain(
                table, px, py, pz, geo0, max_half, resolution, cascades,
                cap_blocks)
        return occupancy_probe_block_aabb_xyz_plain(
            table, px, py, pz, geo0, geo1, resolution, cap_blocks)
    name = 'block_probe_xyz'
    shape = px.shape
    px, py, pz = (t.reshape(-1) for t in (px, py, pz))
    _kernels.require_cuda(name, table, px, py, pz, geo0, geo1,
                          dtypes=(torch.int32,) + (torch.float32,) * 5)
    if py.shape != px.shape or pz.shape != px.shape:
        raise KernelError(f'{name}: coordinate planes differ in shape')
    if geo0.numel() != 3 or geo1.numel() != 3:
        raise KernelError(f'{name}: the center or box corners must have 3 '
                          'entries')
    cr, rr, fr = block_table_rows(resolution, cap_blocks, max(cascades, 1))
    if table.shape != (cr + rr + fr, 128):
        raise KernelError(f'{name}: table must be ({cr + rr + fr}, 128), got '
                          f'{tuple(table.shape)}')
    # m / base_half, a CUDA tensor divided by a Python float, is PyTorch's
    # product with the f32 reciprocal of f32(base_half); (2 * base_half) *
    # exp2(c) multiplies by f32(2 * base_half).
    base_half = max_half / (2 ** (cascades - 1)) if cascades > 0 else 1.0
    inv_base_half = float(np.float32(1.0) / np.float32(base_half))
    two_base_half = float(np.float32(2.0 * base_half))
    n = px.shape[0]
    out = torch.empty(n, dtype=torch.uint8, device=px.device)
    code = _kernels.load_library().nerficg_block_probe_xyz(
        table.data_ptr(), px.data_ptr(), py.data_ptr(), pz.data_ptr(),
        geo0.data_ptr(), geo1.data_ptr(), out.data_ptr(), n, resolution,
        cap_blocks, cr, rr, cascades, inv_base_half, two_base_half,
        _kernels.stream_of(px))
    _kernels.check(code, name)
    block_probe_xyz.launches += 1
    return out.view(torch.bool).reshape(shape)


block_probe_xyz.launches = 0


def occupancy_probe_block_cascaded_xyz(table: torch.Tensor, px: torch.Tensor,
                                       py: torch.Tensor, pz: torch.Tensor,
                                       center: torch.Tensor, max_half: float,
                                       resolution: int, cascades: int,
                                       cap_blocks: int) -> torch.Tensor:
    """Cascaded block-bitfield probe from world-coordinate planes: one
    ``block_probe_xyz`` launch on CUDA tensors,
    ``occupancy_probe_block_cascaded_xyz_plain`` on CPU ones."""
    return block_probe_xyz(table, px, py, pz, center, center, resolution,
                           cap_blocks, cascades, max_half)


def occupancy_probe_block_aabb_xyz(table: torch.Tensor, px: torch.Tensor,
                                   py: torch.Tensor, pz: torch.Tensor,
                                   aabb_min: torch.Tensor,
                                   aabb_max: torch.Tensor, resolution: int,
                                   cap_blocks: int) -> torch.Tensor:
    """Single-grid block-bitfield probe from world-coordinate planes over
    the box [aabb_min, aabb_max]: one ``block_probe_xyz`` launch on CUDA
    tensors, ``occupancy_probe_block_aabb_xyz_plain`` on CPU ones."""
    return block_probe_xyz(table, px, py, pz, aabb_min, aabb_max, resolution,
                           cap_blocks, 0)


def num_cascades(scale: float) -> int:
    """cascades = max(1 + ceil(log2(2*scale)), 1)
    (reference: InstantNGP/Model.py:53)."""
    return max(1 + int(math.ceil(math.log2(max(2.0 * scale, 1e-6)))), 1)


def cascade_of_positions(positions: torch.Tensor, center: torch.Tensor,
                         max_half: float, cascades: int) -> torch.Tensor:
    """Finest cascade containing each position (..., 3) -> (...,) int32;
    cascade c covers the box of half-extent max_half * 2^(c - (C-1))
    (reference: the NGP mip selection, raymarching.cu mip_from_pos)."""
    m = (positions - center).abs().amax(-1)
    base_half = max_half / (2 ** (cascades - 1))
    c = torch.ceil(torch.log2(torch.clamp(m / base_half, min=1.0)))
    return torch.clamp(c.to(torch.int32), 0, cascades - 1)


def occupancy_probe_cascaded_xyz(packed: torch.Tensor, px: torch.Tensor,
                                 py: torch.Tensor, pz: torch.Tensor,
                                 center: torch.Tensor, max_half: float,
                                 resolution: int) -> torch.Tensor:
    """Occupancy (bool, shape of ``px``) of world-coordinate planes in
    (C, words, 128) bitfields (``downsample_occupancy_cascaded``), each
    point tested in its finest containing cascade. Cascade c's words start
    at c * words * 128: ``pack_bits`` pads each cascade to whole rows, so
    the offset is not (c * res^3) >> 5 unless res^3 fills them."""
    c, cx, cy, cz = _cascade_cell_coords(px, py, pz, center, max_half,
                                         resolution, packed.shape[0])
    local = (cx * resolution + cy) * resolution + cz
    word_idx = c * (packed.shape[1] * 128) + (local >> 5)
    return probe_packed_bits(packed.reshape(-1, 128), word_idx, local & 31)


def occupancy_probe_cascaded(packed: torch.Tensor, positions: torch.Tensor,
                             center: torch.Tensor, max_half: float,
                             resolution: int) -> torch.Tensor:
    """``occupancy_probe_cascaded_xyz`` of world positions (..., 3)."""
    return occupancy_probe_cascaded_xyz(
        packed, positions[..., 0], positions[..., 1], positions[..., 2],
        center, max_half, resolution)


def cascade_cell_positions(cells: torch.Tensor, offsets: torch.Tensor,
                           center: torch.Tensor, max_half: float,
                           resolution: int, cascades: int) -> torch.Tensor:
    """Flat cascade-grid cell ids (+ intra-cell offsets in [0,1)^3) ->
    world positions; inverse of the cascaded probe indexing."""
    res3 = resolution ** 3
    c = cells // res3
    local = cells % res3
    z = local % resolution
    y = (local // resolution) % resolution
    x = local // (resolution * resolution)
    coords = torch.stack([x, y, z], -1).float() + offsets
    unit = coords / resolution
    base_half = max_half / (2 ** (cascades - 1))
    half = base_half * torch.exp2(c.float())
    return center + (unit - 0.5) * 2.0 * half[..., None]
