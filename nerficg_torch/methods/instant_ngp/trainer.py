"""Instant-NGP trainer: Adam, step LR, dynamic ray batching, occupancy.

Port of nerficg_tpu/methods/instant_ngp/trainer.py (reference:
src/Methods/InstantNGP/Trainer.py:15-120): Adam with eps 1e-15, MultiStepLR
x0.33 at the milestones, the ray count resized every 16 iterations toward
TARGET_BATCH_SIZE samples per step (snapped to power-of-two buckets, as the
JAX package does), occupancy updates every 16 iterations with full-grid
refreshes during warm-up, a random background per batch, and
loss = masked MSE + WEIGHT_DECAY * mean squared MLP weight + the method's
``_loss_extras`` term (D-NeRF: its offset prior).

Ray ids and backgrounds are drawn from ``np.random.default_rng(RANDOM_SEED)``
in the JAX trainer's order, so both trainers see the same batches; the march
jitter and encode seeds (uint32) come from the trainer's CPU generator. One
host sync per resize interval reads the previous interval's statistics.

With ``GLOBAL.NUM_DEVICES`` = N > 1 (N ranks of a process group, started by
torchrun) every step is data-parallel, as the JAX trainer's ``shard_map``
step (nerficg_tpu trainer.py:228-296, parallel/data_parallel.py): every
rank draws the same global ids and background from its identically seeded
generator, takes its contiguous block of the ids, marches with its seeds
folded with its rank, and the gradients are averaged over the ranks before
every rank's Adam step; ``samples_per_ray`` comes from the global ray
count and SCAN_STEPS is ignored. Every rank refreshes the occupancy grid
from the same generator and takes the same resize, refresh and checkpoint
decisions, so parameters and grid stay bit-equal on every rank. The sample
and block counts are summed over the ranks (the JAX step returns device
0's), so the resizer sees the global count, as in one process.
"""

from __future__ import annotations

import numpy as np
import torch

from nerficg_torch.core.config import Configurable
from nerficg_torch.core.errors import TrainerError
from nerficg_torch.core.logging import Logger
from nerficg_torch.methods.base.callbacks import (pre_training_callback,
                                                  training_callback)
from nerficg_torch.methods.base.trainer import (BaseTrainer,
                                                adam_state_from_numpy,
                                                adam_state_to_numpy)
from nerficg_torch.optim.lr import multistep_lr
from nerficg_torch.optim.metrics import mse_to_psnr
from nerficg_torch.parallel.data_parallel import (fold_seed,
                                                  make_data_parallel_train_step)
from nerficg_torch.parallel.mesh import RenderMesh

__all__ = ['InstantNGPTrainer']


@Configurable.configure(
    NUM_ITERATIONS=50000,
    TARGET_BATCH_SIZE=262144,     # samples per step (reference: Trainer.py:17)
    INITIAL_RAYS_PER_BATCH=4096,
    MAX_RAYS_PER_BATCH=65536,
    LR=1e-2,
    LR_MILESTONES=[20000, 30000, 40000],
    LR_GAMMA=0.33,
    WEIGHT_DECAY=5e-7,
    OCCUPANCY_UPDATE_INTERVAL=16,
    OCCUPANCY_WARMUP_STEPS=256,
    RANDOM_BACKGROUND=True,
    BATCH_RESIZE_INTERVAL=16,
    SCAN_STEPS=1,                 # K > 1: K steps back to back per window
    LOG_INTERVAL=1000,
)
class InstantNGPTrainer(BaseTrainer):

    DATA_PARALLEL = True

    def __init__(self, config, model, renderer):
        super().__init__(config, model, renderer)
        self.num_devices = self._num_devices()
        self.mesh = RenderMesh(self.num_devices)
        self._dp_step = None
        self.schedule = multistep_lr(float(self.LR), list(self.LR_MILESTONES),
                                     float(self.LR_GAMMA))
        self.optimizer = torch.optim.Adam(model.module.parameters(),
                                          lr=float(self.LR), eps=1e-15)
        self.updates = 0               # optimizer steps taken
        self.rays_per_batch = int(self.INITIAL_RAYS_PER_BATCH)
        self._pool = None
        self._measured: list[torch.Tensor] = []
        self._pending_stats = None
        self.losses: list[torch.Tensor] = []    # per-step loss, on the card
        self._last_logs: dict = {}

    def _num_devices(self) -> int:
        """``GLOBAL.NUM_DEVICES`` capped at the group's ranks (all of them
        when unset), as the JAX trainer caps it at its devices; a count
        below the group's would leave ranks out of the step, and
        raises."""
        configured = self._config.get_path('GLOBAL.NUM_DEVICES') \
            if self._config is not None else None
        n = min(int(configured), self.world_size) if configured \
            else self.world_size
        if n < self.world_size:
            raise TrainerError(
                f'GLOBAL.NUM_DEVICES={configured} is below the '
                f'{self.world_size} ranks of this run: launch with '
                f'python -m torch.distributed.run --nproc_per_node '
                f'{configured} ... GLOBAL.NUM_DEVICES={configured}')
        return n

    # -- optimizer state ----------------------------------------------------------
    def _named_params(self):
        return list(self.model.module.named_parameters())

    def get_optimizer_state(self) -> dict:
        return adam_state_to_numpy(self.optimizer, self._named_params(),
                                   self.updates)

    def set_optimizer_state(self, state: dict) -> None:
        self.updates = adam_state_from_numpy(self.optimizer,
                                             self._named_params(), state)

    def on_resume(self, dataset) -> None:
        self._init_samplers(dataset)

    def get_resume_metadata(self) -> dict:
        return {'rays_per_batch': int(self.rays_per_batch)}

    def set_resume_metadata(self, meta: dict) -> None:
        if 'rays_per_batch' in meta:
            self.rays_per_batch = int(meta['rays_per_batch'])

    # -- setup ----------------------------------------------------------------------
    @pre_training_callback(priority=4000)
    def _init_samplers(self, dataset) -> None:
        rays = dataset.precompute_rays('train', device=self.device).rays
        self._pool = {'origins': rays.origins, 'directions': rays.directions,
                      'rgb': rays.rgb, 'alpha': rays.alpha,
                      'timestamps': rays.timestamps}
        self._pool_size = int(rays.origins.shape[0])
        self._np_rng = np.random.default_rng(self.seed)
        self._bg_static = torch.as_tensor(
            dataset.camera_settings.background_color, dtype=torch.float32,
            device=self.device)
        # The ranks start from rank 0's parameters.
        self.mesh.replicate([p.data for p in self.model.module.parameters()])

    @pre_training_callback(priority=3500)
    def _carve_occupancy(self, dataset) -> None:
        """Frustum-carve the grid from the training views before the warm-up
        refresh (reference: InstantNGP/Renderer.py:207-243)."""
        if bool(self.renderer.CARVE_OCCUPANCY) and dataset.subsets['train']:
            self.renderer.carve_occupancy_grid(dataset.subsets['train'])

    @pre_training_callback(priority=3000)
    def _warmup_occupancy(self, dataset) -> None:
        """Full-grid refresh before training (reference warm-up at :66-70)."""
        self.renderer.update_occupancy_grid(self.generator, warmup=True)

    # -- one step -----------------------------------------------------------------
    def samples_per_ray(self, num_rays: int) -> int:
        """The total sample budget stays at TARGET_BATCH_SIZE whatever the
        ray count (reference: InstantNGP/Trainer.py:73-78)."""
        return min(max(int(self.TARGET_BATCH_SIZE) // num_rays, 4),
                   int(self.renderer.MAX_SAMPLES))

    def loss_and_grads(self, ids: torch.Tensor, background: torch.Tensor,
                       jitter_seed: int, encode_seed: int) -> dict:
        """Forward and backward of one batch (nerficg_tpu trainer.py:163-194);
        the gradients land in the parameters' ``.grad``. Returns the logs as
        tensors on the card."""
        pool = self._pool
        target = pool['rgb'][ids]
        if pool['alpha'] is not None:
            alpha = pool['alpha'][ids]
            target = target * alpha + background * (1.0 - alpha)
        times = pool['timestamps'][ids] \
            if self.renderer.TIME_CONDITIONED else None
        # The sample budget is the whole batch's (over every rank).
        spr = self.samples_per_ray(ids.shape[0] * self.num_devices)
        out = self.renderer._render_rays_impl(
            self.renderer.grid_binary(), pool['origins'][ids],
            pool['directions'][ids], background, spr,
            jitter_seed=jitter_seed, encode_seed=encode_seed,
            timestamps=times)
        # Rays whose samples the budget truncated are left out: they would
        # otherwise train toward black.
        mask = out['ray_mask']
        err = (out['rgb'] - target) ** 2 * mask
        color = err.sum() / torch.clamp(mask.sum() * 3.0, min=1.0)
        wd = self.model.mlp_weight_squares()
        extra, extra_logs = self._loss_extras()
        loss = color + float(self.WEIGHT_DECAY) * wd + extra
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        return {'color': color.detach(), 'weight_decay': wd.detach(),
                'total': loss.detach(), 'psnr': mse_to_psnr(color.detach()),
                'num_samples': out['num_samples'],
                'num_blocks': out['num_blocks'],
                'ray_mask_frac': mask.mean(), **extra_logs}

    def _loss_extras(self) -> tuple:
        """A method's further loss term and its logs (D-NeRF: the offset
        prior), added to the loss of every step."""
        return 0.0, {}

    def apply_update(self) -> None:
        """Adam with the schedule's rate at the step count before the
        update (optax's convention)."""
        lr = self.schedule(self.updates)
        for group in self.optimizer.param_groups:
            group['lr'] = lr
        self.optimizer.step()
        self.updates += 1

    def train_step(self, ids: torch.Tensor, background: torch.Tensor,
                   jitter_seed: int, encode_seed: int) -> dict:
        """One step on the whole batch ``ids``: on more than one device,
        the data-parallel step over this rank's block."""
        if self.num_devices > 1:
            return self._data_parallel_step()(
                {'ids': ids, 'bg': background.expand(self.num_devices, 3)},
                (jitter_seed, encode_seed))
        logs = self.loss_and_grads(ids, background, jitter_seed, encode_seed)
        self.apply_update()
        return logs

    def _fold_seed(self, seed: int, rank: int) -> int:
        """This rank's seed of a step's ``seed`` (the JAX step folds the
        device index into its key)."""
        return fold_seed(seed, rank)

    def _data_parallel_step(self):
        """The step of ``parallel.make_data_parallel_train_step`` over
        ``loss_and_grads`` and ``apply_update``, built at first use (D-NeRF
        replaces the optimizer after this constructor)."""
        if self._dp_step is None:
            def grad_fn(batch, seeds):
                return self.loss_and_grads(batch['ids'], batch['bg'][0],
                                           *seeds)
            self._dp_step = make_data_parallel_train_step(
                self.mesh, grad_fn, self.optimizer, update=self.apply_update,
                fold=self._fold_seed)
        return self._dp_step

    def _draw_batch(self, k: int | None):
        """Ray ids and backgrounds from the numpy generator, in the JAX
        trainer's order; k steps at once for SCAN_STEPS."""
        n = self.rays_per_batch
        ids = self._np_rng.integers(0, self._pool_size,
                                    size=n if k is None else (k, n))
        ids = torch.as_tensor(ids, device=self.device)
        if not bool(self.RANDOM_BACKGROUND):
            return ids, self._bg_static.expand(
                (3,) if k is None else (k, 3))
        bg = self._np_rng.random(3 if k is None else (k, 3))
        return ids, torch.as_tensor(bg, dtype=torch.float32,
                                    device=self.device)

    def _run_step(self, ids: torch.Tensor, bg: torch.Tensor) -> None:
        logs = self.train_step(ids, bg, self.next_seed(), self.next_seed())
        self._last_logs = logs
        self.losses.append(logs['total'])
        self._measured.append(torch.stack([
            logs['num_samples'].float(), logs['ray_mask_frac'].float(),
            logs['num_blocks'].float()]))

    # -- callbacks -----------------------------------------------------------------
    @training_callback(priority=200,
                       iteration_stride='OCCUPANCY_UPDATE_INTERVAL')
    def _update_occupancy(self, dataset, iteration: int) -> None:
        warmup = iteration < int(self.OCCUPANCY_WARMUP_STEPS)
        self.renderer.update_occupancy_grid(self.generator, warmup=warmup)

    @training_callback(priority=100)
    def training_iteration(self, dataset, iteration: int) -> None:
        # SCAN_STEPS = K: K steps run back to back on window boundaries; the
        # iteration counter still advances one by one, so the checkpoint,
        # backup and occupancy schedules keep their semantics, quantized to
        # the window (nerficg_tpu trainer.py:306-334). Data-parallel steps
        # ignore it, as the JAX trainer's do.
        k = max(int(self.SCAN_STEPS), 1)
        if k > 1 and self.num_devices == 1:
            if iteration % k != 0:
                return
            ids, bg = self._draw_batch(k)
            for j in range(k):
                self._run_step(ids[j], bg[j])
            return
        ids, bg = self._draw_batch(None)
        self._run_step(ids, bg)

    @training_callback(priority=90, iteration_stride='BATCH_RESIZE_INTERVAL',
                       start_iteration='BATCH_RESIZE_INTERVAL')
    def _resize_batch(self, dataset, iteration: int) -> None:
        """Ray count toward TARGET_BATCH_SIZE samples, snapped to power-of-two
        buckets (reference: Trainer.py:73-78). This interval's means start an
        asynchronous copy to the host; the decision reads the previous
        interval's, which landed long ago: one interval of lag and one short
        host sync per interval."""
        if not self._measured:
            return
        stats = torch.stack(self._measured).mean(0)
        self._measured.clear()
        event = None
        if stats.is_cuda:
            host = torch.empty(3, pin_memory=True)
            host.copy_(stats, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            stats = host
        prev, self._pending_stats = self._pending_stats, \
            (stats, event, self.rays_per_batch)
        if prev is None:
            return
        prev_stats, prev_event, prev_rays = prev
        n = self.rays_per_batch
        if prev_rays != n:
            return                    # stats are from a different bucket
        if prev_event is not None:
            prev_event.synchronize()
        _, mask_frac, mean_blocks = prev_stats.tolist()
        budget_blocks = int(self.TARGET_BATCH_SIZE) // \
            int(self.renderer.MARCH_BLOCK)
        blocks_per_ray = max(mean_blocks, 1.0) / n
        desired = budget_blocks / blocks_per_ray
        bucket = 1 << int(np.round(np.log2(max(desired, 256))))
        bucket = int(np.clip(bucket, 256, int(self.MAX_RAYS_PER_BATCH)))
        if bucket != n:
            Logger.verbose(f'iter {iteration}: rays/batch {n} -> {bucket} '
                           f'(mask {mask_frac:.3f}, {blocks_per_ray:.1f} '
                           'blocks/ray)')
            self.rays_per_batch = bucket

    @training_callback(priority=45, iteration_stride='LOG_INTERVAL',
                       start_iteration='LOG_INTERVAL')
    def _wandb_log_occupancy(self, dataset, iteration: int) -> None:
        """Occupancy-grid 3D panel and occupied-cell count (reference:
        src/Methods/InstantNGP/utils.py:20-64 logs the grid as a wandb
        Object3D point cloud)."""
        if self._wandb is None or not self._wandb.active:
            return
        centers = self.renderer.occupied_cell_centers()
        self._wandb.log({'occupancy/occupied_cells': int(centers.shape[0])},
                        step=iteration)
        if centers.shape[0]:
            self._wandb.log_point_cloud('occupancy/grid', centers,
                                        step=iteration)

    @training_callback(priority=50, iteration_stride='LOG_INTERVAL')
    def _log_progress(self, dataset, iteration: int) -> None:
        if self._last_logs:
            Logger.verbose(f'iter {iteration}: ' + ', '.join(
                f'{k}={float(v):.4f}' for k, v in self._last_logs.items()))
