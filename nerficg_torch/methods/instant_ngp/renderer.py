"""Instant-NGP renderer: occupancy-skipping marching + packed compositing.

Port of nerficg_tpu/methods/instant_ngp/renderer.py (reference:
src/Methods/InstantNGP/Renderer.py:39-272). An image is rendered
in fixed-size ray chunks: each chunk is marched through the skip grid
(PROBE_MODE 'block': the two-level block bitfield, probed by
``block_probe_xyz``; 'dense': flat packed bitfields, probed through
``xbar_gather``) at INFERENCE_SAMPLES_PER_RAY samples per ray, its samples
are encoded and shaded (in morton order for the windowed encodes, 'window' and
'cell'; in ray order for 'xbar') and composited in ray order; then the
rays the budget truncated while still transmissive are marched again at
INFERENCE_REFINE_FACTOR x the budget and merged back (the static-shape
stand-in for the reference's alive-ray loop).

Training renders one ray batch per step through ``_render_rays_impl`` with
jittered samples and the stochastic encode, and keeps the density grid up to
date: ``carve_occupancy_grid`` once before training, ``update_occupancy_grid``
every few steps. Their random draws come from a CPU ``torch.Generator``.

A time-conditioned subclass (D-NeRF) sets ``TIME_CONDITIONED``: rays then
carry their timestamps into ``_render_rays_impl``, which hands each sample
its ray's time through the ``_field`` hook. Static models skip that work.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nerficg_torch.core.config import Configurable
from nerficg_torch.core.errors import RendererError
from nerficg_torch.core.logging import Logger
from nerficg_torch.data.types import RayBatch, View
from nerficg_torch.methods.base.renderer import BaseRenderer
from nerficg_torch.methods.instant_ngp.model import InstantNGPModel
from nerficg_torch.ops.occupancy import (cascade_cell_positions,
                                         composite_packed,
                                         downsample_occupancy,
                                         downsample_occupancy_block,
                                         downsample_occupancy_cascaded,
                                         downsample_occupancy_cascaded_block,
                                         draw_grid_update, march_rays,
                                         occupancy_probe_block_aabb_xyz,
                                         occupancy_probe_block_cascaded_xyz,
                                         occupancy_probe_cascaded_xyz,
                                         update_density_grid)
from nerficg_torch.ops.sample_sort import permute_block_channels

__all__ = ['InstantNGPRenderer']


@Configurable.configure(
    MAX_SAMPLES=512,            # marching steps per ray (reference: 1024)
    MARCH_RESOLUTION=128,       # skip-grid resolution probed by the marcher
    PROBE_MODE='block',         # 'block': two-level rank-compacted block
                                # bitfield; 'dense': flat packed bitfields
    PROBE_CAP_BLOCKS=0,         # 0 = auto (total_blocks/4, min 256)
    AVG_SAMPLES_PER_RAY=24,     # training compaction budget per ray
    INFERENCE_SAMPLES_PER_RAY=128,
    MARCH_BLOCK=8,              # compaction granularity (steps per block)
    DENSITY_THRESHOLD=0.01,
    EARLY_STOP_EPS=1e-4,
    RAY_BATCH_SIZE=8192,
    EXPONENTIAL_STEPS=None,     # None = auto (on for multi-cascade scenes)
    INFERENCE_REFINE=True,
    INFERENCE_REFINE_FRACTION=0.25,   # max refined rays per chunk
    INFERENCE_REFINE_FACTOR=4,
    OCCUPANCY_DECAY=0.95,
    OCCUPANCY_SAMPLES=262144,   # cells refreshed per update
    OCCUPANCY_OCCUPIED_BIAS=0.5,  # share of updates aimed at occupied bins
    CARVE_OCCUPANCY=True,       # frustum-carve the grid from training views
)
class InstantNGPRenderer(BaseRenderer):

    MODEL_CLASS = InstantNGPModel
    # Whether the field reads the rays' timestamps (methods/dnerf).
    TIME_CONDITIONED = False

    def __init__(self, config, model, mesh=None):
        super().__init__(config, model, mesh)
        if str(self.PROBE_MODE) not in ('block', 'dense'):
            raise RendererError(f'unknown PROBE_MODE {self.PROBE_MODE!r}; '
                                "one of 'block', 'dense'")
        self._probe_block = str(self.PROBE_MODE) == 'block'
        # Skip-grid resolution cannot exceed the density grid's.
        self._march_res = min(int(self.MARCH_RESOLUTION),
                              int(self.model.GRID_RESOLUTION))
        # Candidate probes per block, spaced so no cell crossing wider than
        # one probe gap is missed.
        self._probes_per_block = max(2, int(np.ceil(
            int(self.MARCH_BLOCK) * self._march_res * (3.0 ** 0.5) /
            float(self.MAX_SAMPLES))))
        self._cascades = int(self.model.cascades)
        exp = self.EXPONENTIAL_STEPS
        self._exponential = bool(self._cascades > 1 if exp is None else exp)
        total_blocks = self._cascades * (self._march_res // 8) ** 3
        cap = int(self.PROBE_CAP_BLOCKS) or max(256, total_blocks // 4)
        self._cap_blocks = min(-(-cap // 8) * 8, total_blocks)
        self._grid_cache_src: Optional[torch.Tensor] = None
        self._grid_binary_cache: Optional[torch.Tensor] = None
        self._background = torch.zeros(3, device=self.model.device)

    @property
    def density_threshold(self) -> float:
        """Alpha threshold -> density threshold given the mean step length."""
        extent = 2.0 * float(self.model.SCALE)
        mean_step = extent * (3.0 ** 0.5) / float(self.MAX_SAMPLES)
        return float(self.DENSITY_THRESHOLD) / mean_step

    def grid_binary(self) -> torch.Tensor:
        """The marching skip grid, cached while the density grid tensor
        stays the same object: 'block', one packed block bitfield over all
        cascades; 'dense', (C, words, 128) bitfields with several
        cascades, else one (words, 128) bitfield (nerficg_tpu renderer.py:
        115-144)."""
        grid = self.model.buffers['density_grid']
        if self._grid_cache_src is not grid:
            res, mres = int(self.model.GRID_RESOLUTION), self._march_res
            threshold, cascades = self.density_threshold, self._cascades
            if self._probe_block and cascades > 1:
                binary = downsample_occupancy_cascaded_block(
                    grid, res, mres, threshold, cascades, self._cap_blocks)
            elif self._probe_block:
                binary = downsample_occupancy_block(grid, res, mres,
                                                    threshold,
                                                    self._cap_blocks)
            elif cascades > 1:
                binary = downsample_occupancy_cascaded(grid, res, mres,
                                                       threshold, cascades)
            else:
                binary = downsample_occupancy(grid, res, mres, threshold)
            self._grid_binary_cache = binary
            self._grid_cache_src = grid
        return self._grid_binary_cache

    def _probe_fn(self, grid_binary: torch.Tensor):
        """The marcher's probe of world planes; None for one dense grid,
        which the marcher probes itself."""
        res, model = self._march_res, self.model
        if not self._probe_block:
            if self._cascades == 1:
                return None
            return lambda px, py, pz: occupancy_probe_cascaded_xyz(
                grid_binary, px, py, pz, model.center, float(model.SCALE),
                res)
        if self._cascades > 1:
            return lambda px, py, pz: occupancy_probe_block_cascaded_xyz(
                grid_binary, px, py, pz, model.center, float(model.SCALE),
                res, self._cascades, self._cap_blocks)
        return lambda px, py, pz: occupancy_probe_block_aabb_xyz(
            grid_binary, px, py, pz, model.aabb_min, model.aabb_max, res,
            self._cap_blocks)

    def _render_rays_impl(self, grid_binary: torch.Tensor,
                          origins: torch.Tensor, directions: torch.Tensor,
                          background: torch.Tensor, samples_per_ray: int,
                          jitter_seed: Optional[int] = None,
                          encode_seed: Optional[int] = None,
                          timestamps: Optional[torch.Tensor] = None) -> dict:
        """One ray batch. Training passes ``jitter_seed`` (sample jitter)
        and ``encode_seed`` (stochastic corners), both uint32; without them
        samples sit at step midpoints and the encode is exact. With
        ``timestamps`` (one per ray) every sample gets its ray's time."""
        n = origins.shape[0]
        block = int(self.MARCH_BLOCK)
        windowed = str(self.model.ENCODING_BACKEND) in ('window', 'cell')
        march = march_rays(
            origins, directions, self.model.aabb_min, self.model.aabb_max,
            self._probe_fn(grid_binary), max_steps=int(self.MAX_SAMPLES),
            sample_budget=n * samples_per_ray, block=block,
            exponential=self._exponential, morton=windowed,
            probes_per_block=self._probes_per_block, seed=jitter_seed,
            grid_binary=grid_binary, grid_resolution=self._march_res)
        sample_times = None
        if timestamps is not None:
            # Ray ids are constant over a block: the owning ray's time is
            # gathered once per block (padding blocks take the drop slot's
            # 0) and broadcast (nerficg_tpu renderer.py:204-215).
            ids = march.ray_ids_m if windowed else march.ray_ids
            t_flat = torch.nn.functional.pad(timestamps.reshape(-1), (0, 1))
            block_ids = torch.clamp(ids.reshape(-1, block)[:, 0], max=n)
            sample_times = t_flat[block_ids][:, None].expand(
                -1, block).reshape(-1)
        if windowed:
            # The field runs on the morton-ordered stream, so the windowed
            # encode's per-sub-block table windows stay tight; its outputs
            # return to ray order as whole blocks.
            sigma_m, rgb_m = self._field(march.positions_m,
                                         march.directions_m, encode_seed,
                                         sample_times,
                                         anchor_keys=march.block_keys_m)
            ch = permute_block_channels(
                torch.stack([sigma_m, rgb_m[:, 0], rgb_m[:, 1], rgb_m[:, 2]]),
                block, march.perm_to_ray, march.perm_to_morton)
            sigma, rgb = ch[0], ch[1:4]      # rgb channel-major (3, B)
        else:
            sigma, rgb = self._field(march.positions, march.directions,
                                     encode_seed, sample_times)
        sigma = torch.where(march.valid, sigma, 0.0)
        out = composite_packed(sigma, rgb, march, n,
                               background=background,
                               early_stop_eps=float(self.EARLY_STOP_EPS),
                               block=block)
        out['ray_mask'] = march.ray_complete[:, None].float()
        out['num_samples'] = march.num_valid
        out['num_blocks'] = march.num_blocks
        return out

    def _field(self, positions: torch.Tensor, directions: torch.Tensor,
               encode_seed: Optional[int],
               sample_times: Optional[torch.Tensor],
               anchor_keys: Optional[torch.Tensor] = None):
        """Field-evaluation hook; time-conditioned methods override it to
        read the per-sample times (methods/dnerf)."""
        return self.model.field(positions, directions,
                                encode_seed=encode_seed,
                                anchor_keys=anchor_keys)

    def _refine_impl(self, grid_binary: torch.Tensor, origins: torch.Tensor,
                     directions: torch.Tensor, background: torch.Tensor,
                     out: dict,
                     timestamps: Optional[torch.Tensor] = None) -> dict:
        """Re-march up to a fixed fraction of the chunk's rays, those whose
        samples the budget truncated while still transmissive, at a larger
        per-ray budget, and merge them back."""
        chunk = origins.shape[0]
        r2 = max(int(chunk * float(self.INFERENCE_REFINE_FRACTION)), 128)
        unfinished = (out['ray_mask'][:, 0] < 0.5) & \
            (out['alpha'][:, 0] < 0.995)
        # jnp.nonzero(size=r2, fill_value=chunk) without a host sync: a
        # stable sort puts the unfinished rays first, in ray order.
        order = torch.sort((~unfinished).to(torch.uint8), stable=True).indices
        order = torch.nn.functional.pad(order, (0, max(r2 - chunk, 0)))[:r2]
        valid = torch.arange(r2, device=order.device) < unfinished.sum()
        ids = torch.where(valid, order, chunk)
        safe = torch.clamp(ids, max=chunk - 1)
        out2 = self._render_rays_impl(
            grid_binary, origins[safe], directions[safe], background,
            samples_per_ray=int(self.INFERENCE_SAMPLES_PER_RAY) *
            int(self.INFERENCE_REFINE_FACTOR),
            timestamps=None if timestamps is None else timestamps[safe])
        merged = dict(out)
        for key in ('rgb', 'depth', 'alpha'):
            # Only the valid entries are written: padding entries go to a
            # spare row that is cut off again.
            dst = torch.cat([out[key], out[key][:1]], 0)
            dst[ids] = out2[key]
            merged[key] = dst[:chunk]
        return merged

    # -- density grid --------------------------------------------------------
    @torch.no_grad()
    def _update_grid_impl(self, density_grid: torch.Tensor, draws,
                          encode_seed: int,
                          carve_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """One grid refresh (nerficg_tpu renderer.py:253-278): the slab's
        cells are queried with the stochastic encode (forward only)."""
        return self._refresh_grid(
            density_grid, draws,
            lambda positions: self.model.density(
                positions, encode_seed=encode_seed)[0], carve_mask,
            self.density_threshold)

    def _refresh_grid(self, density_grid: torch.Tensor, draws, query,
                      carve_mask: Optional[torch.Tensor],
                      occupied_threshold: float) -> torch.Tensor:
        """``update_density_grid`` with the density ``query``; the biased
        slab starts count the cells above ``occupied_threshold``."""
        model = self.model
        position_fn = None
        if self._cascades > 1:
            position_fn = lambda cells, offs: cascade_cell_positions(
                cells, offs, model.center, float(model.SCALE),
                int(model.GRID_RESOLUTION), self._cascades)
        return update_density_grid(
            density_grid, query,
            model.aabb_min, model.aabb_max, int(model.GRID_RESOLUTION),
            draws, decay=float(self.OCCUPANCY_DECAY),
            position_fn=position_fn, carve_mask=carve_mask,
            occupied_threshold=occupied_threshold)

    def update_occupancy_grid(self, generator: torch.Generator,
                              warmup: bool = False) -> None:
        """Refresh the density grid with draws from ``generator``
        (reference: Renderer.py:245-272)."""
        grid = self.model.buffers['density_grid']
        draws = draw_grid_update(generator, grid.shape[0],
                                 int(self.OCCUPANCY_SAMPLES), warmup=warmup,
                                 occupied_bias=float(
                                     self.OCCUPANCY_OCCUPIED_BIAS))
        encode_seed = int(torch.randint(0, 2 ** 32, (1,),
                                        generator=generator))
        self.model.buffers['density_grid'] = self._update_grid_impl(
            grid, draws, encode_seed, self.model.buffers.get('carve_mask'),
            **self._grid_draws(generator))

    def _grid_draws(self, generator: torch.Generator) -> dict:
        """Further random arguments of ``_update_grid_impl``, drawn after
        the cells and the encode seed (D-NeRF: the refresh's time)."""
        return {}

    @torch.no_grad()
    def occupied_cell_centers(self, max_points: int = 65536) -> np.ndarray:
        """World-space centers of the occupied grid cells, at most
        ``max_points`` of them (a seeded subset): the wandb occupancy
        panel's points (reference: src/Methods/InstantNGP/utils.py:20-64)."""
        model = self.model
        grid = model.buffers['density_grid'].cpu().numpy()
        occ = np.nonzero(grid > self.density_threshold)[0]
        if occ.size > max_points:
            occ = occ[np.random.default_rng(0).choice(occ.size, max_points,
                                                      replace=False)]
        cells = torch.as_tensor(occ, dtype=torch.int32, device=model.device)
        centers = cascade_cell_positions(
            cells, torch.full((cells.shape[0], 3), 0.5, device=model.device),
            model.center, float(model.SCALE), int(model.GRID_RESOLUTION),
            self._cascades)
        return centers.cpu().numpy()

    @torch.no_grad()
    def carve_occupancy_grid(self, views, dilate: int = 1) -> None:
        """Frustum carving: cells outside every training camera's frustum
        (with a 10% margin) stay empty; the visible set is dilated by
        ``dilate`` cells (6-neighbourhood) on the host (reference:
        InstantNGP/Renderer.py:207-243; nerficg_tpu renderer.py:321-384).
        Stores the {0, 1} mask buffer that the grid updates read."""
        model = self.model
        res = int(model.GRID_RESOLUTION)
        cascades = self._cascades
        total = cascades * res ** 3
        device = model.device
        cells = torch.arange(total, device=device)
        centers = cascade_cell_positions(
            cells, torch.full((total, 3), 0.5, device=device), model.center,
            float(model.SCALE), res, cascades)
        visible = torch.zeros(total, dtype=torch.bool, device=device)
        for view in views:
            camera = view.camera
            # World-to-camera inverted in float64 on the host, as the JAX
            # package's View.w2c does.
            rot_inv = view.c2w[:3, :3].T
            w2c = np.concatenate([rot_inv, -rot_inv @ view.c2w[:3, 3:]], 1)
            w2c = torch.as_tensor(w2c, dtype=torch.float32, device=device)
            pix = camera.cam_to_screen(centers @ w2c[:, :3].T + w2c[:, 3])
            margin = 0.1 * max(camera.width, camera.height)
            visible |= ((pix[:, 2] > 0) & (pix[:, 0] > -margin) &
                        (pix[:, 0] < camera.width + margin) &
                        (pix[:, 1] > -margin) &
                        (pix[:, 1] < camera.height + margin))
        mask = visible.cpu().numpy().reshape(cascades, res, res, res)
        mask = mask.astype(np.float32)
        for _ in range(max(dilate, 0)):
            m = mask
            for axis in (1, 2, 3):
                m = np.maximum(m, np.roll(mask, 1, axis))
                m = np.maximum(m, np.roll(mask, -1, axis))
            mask = m
        model.buffers['carve_mask'] = torch.as_tensor(mask.reshape(-1),
                                                      device=device)
        Logger.verbose(f'occupancy carve: {mask.mean() * 100:.1f}% of cells '
                       'visible')

    @torch.no_grad()
    def render_rays(self, rays: RayBatch,
                    background: Optional[torch.Tensor] = None) -> dict:
        # Inference chunk: the training batch's sample budget spread over
        # the larger per-ray inference budget.
        chunk = max((int(self.RAY_BATCH_SIZE) * int(self.AVG_SAMPLES_PER_RAY))
                    // int(self.INFERENCE_SAMPLES_PER_RAY), 256)
        bg = self._background if background is None else background
        grid = self.grid_binary()
        n = len(rays)
        padded = ((n + chunk - 1) // chunk) * chunk
        rays_p = rays.pad_to(padded)
        timed = self.TIME_CONDITIONED and rays_p.timestamps is not None
        outputs = []
        for i in range(0, padded, chunk):
            origins = rays_p.origins[i:i + chunk]
            directions = rays_p.directions[i:i + chunk]
            times = rays_p.timestamps[i:i + chunk] if timed else None
            out = self._render_rays_impl(
                grid, origins, directions, bg,
                samples_per_ray=int(self.INFERENCE_SAMPLES_PER_RAY),
                timestamps=times)
            if bool(self.INFERENCE_REFINE):
                out = self._refine_impl(grid, origins, directions, bg, out,
                                        timestamps=times)
            outputs.append({k: out[k] for k in ('rgb', 'depth', 'alpha')})
        return {k: torch.cat([o[k] for o in outputs], 0)[:n]
                for k in outputs[0]}

    def render_image(self, view: View,
                     benchmark: bool = False) -> dict[str, torch.Tensor]:
        device = self.model.device
        self._background = torch.as_tensor(view.camera.background_color,
                                           dtype=torch.float32, device=device)
        out = self.render_rays(view.get_rays(with_images=False, device=device))
        h, w = view.camera.height, view.camera.width
        result = {'rgb': out['rgb'].reshape(h, w, 3),
                  'depth': out['depth'].reshape(h, w, 1),
                  'alpha': out['alpha'].reshape(h, w, 1)}
        if benchmark and device.type == 'cuda':
            torch.cuda.synchronize(device)
        return result
