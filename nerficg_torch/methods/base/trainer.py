"""Training engine: a callback-scheduled host loop around the method's step.

Port of nerficg_tpu/methods/base/trainer.py (reference: ``BaseTrainer``,
src/Methods/Base/Trainer.py:31-395). Pre-training callbacks set up, one
training callback per iteration steps the model, post-training callbacks save
the final checkpoint and render the test set. Every callback is timed into
``timings.txt`` and runs in its ``trainer/<callback>`` span
(``core/tracing.py``); device memory goes to ``vram_stats.txt``. The resume
file is the npz checkpoint container with the optimizer state as numpy
arrays. ``TIMING.PROFILE`` traces a window of iterations with
``torch.profiler``, the program's spans included, into
``<output_dir>/profile/trace.json``, and the window's counters into
``profile/counters.json``; ``WANDB.ACTIVATE`` logs losses, render grids and
sweep metrics through ``core/wandb_utils.py``.

In a data-parallel run (``parallel/``; trainers with ``DATA_PARALLEL``)
every rank runs the same callbacks on the same schedule, and rank 0 alone
writes: it chooses the output directory (broadcast to the others) and
writes the config, checkpoints, the resume file, timings, memory stats, the
profile trace, wandb, and the test renders with their metrics. The test
set, and the wandb sweep's test metrics, are rendered over every rank,
each rank its share of the views (``RenderMesh.gather_map``), so no rank
waits on a collective for longer than one view's render. Every rank meets
the others at a barrier after the post-training callbacks.
"""

from __future__ import annotations

import json
import math
import random
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from nerficg_torch.core.checkpoint import load_checkpoint, save_checkpoint
from nerficg_torch.core.config import ConfigNode, Configurable, save_config
from nerficg_torch.core.errors import TrainerError
from nerficg_torch.core.logging import Logger
from nerficg_torch.core.setup import Directories
from nerficg_torch.core.tracing import counters, reset_counters, span
from nerficg_torch.methods.base.callbacks import (MAIN, POST, PRE,
                                                  CallbackTimer,
                                                  gather_callbacks,
                                                  post_training_callback,
                                                  pre_training_callback,
                                                  training_callback)
from nerficg_torch.methods.base.model import BaseModel
from nerficg_torch.methods.base.renderer import BaseRenderer
from nerficg_torch.parallel.mesh import process_count, process_index

__all__ = ['BaseTrainer', 'adam_state_to_numpy', 'adam_state_from_numpy']


@Configurable.configure(
    MODEL_NAME='run',
    NUM_ITERATIONS=10000,
    LOAD_CHECKPOINT=None,
    CHECKPOINT={'INTERVAL': None, 'FINAL': True},
    BACKUP={'INTERVAL': None},
    # TIMING.SAMPLE_EVERY is the JAX trainer's timer sampling, which the
    # port's timer (CUDA events, no waits) does not read. It stays in the
    # defaults because scripts/create_config writes them, and its files
    # are held to the JAX package's (tests/test_torch_create_config.py).
    TIMING={'ACTIVATE': True, 'SAMPLE_EVERY': 16,
            'PROFILE': None, 'PROFILE_STEPS': 5},
    WANDB={'ACTIVATE': False, 'INTERVAL': 100, 'PROJECT': 'nerficg_tpu',
           'LOG_IMAGES': False, 'IMAGE_INTERVAL': 1000,
           'INDEX_TRAINING': 0, 'INDEX_VALIDATION': 0,
           'SWEEP_MODE': {'ACTIVE': False, 'START_ITERATION': 1000,
                          'ITERATION_STRIDE': 5000, 'NUM_IMAGES': 0}},
    RENDER_TESTSET=True,
    RENDER_VALSET=False,
    PRELOAD_DATASET=True,
)
class BaseTrainer(Configurable):

    # Whether the method trains over the ranks of a process group.
    DATA_PARALLEL = False

    def __init__(self, config: ConfigNode | None, model: BaseModel,
                 renderer: BaseRenderer):
        super().__init__(config, 'TRAINING')
        self.rank, self.world_size = process_index(), process_count()
        if self.world_size > 1 and not self.DATA_PARALLEL:
            raise TrainerError(f'{type(self).__name__} trains in one process; '
                               f'this one is rank {self.rank} of '
                               f'{self.world_size} (launch it without '
                               f'torchrun)')
        self._config = config
        self.model = model
        self.renderer = renderer
        self.device = model.device
        self.iteration = model.num_iterations_trained
        self.output_dir: Optional[Path] = None
        self.timers: dict[str, CallbackTimer] = {}
        self.seed = int(config.get_path('GLOBAL.RANDOM_SEED', 42)) \
            if config is not None else 42
        # The trainer's own draws (march/encode seeds, grid updates) come
        # from a CPU generator, so no step waits on the card.
        self.generator = torch.Generator().manual_seed(self.seed)
        self.test_metrics: dict[str, float] = {}
        self._wandb = None

    @property
    def is_writer(self) -> bool:
        """Whether this process writes the run's files (rank 0)."""
        return self.rank == 0

    def next_seed(self) -> int:
        """A fresh uint32 seed from the trainer's generator."""
        return int(torch.randint(0, 2 ** 32, (1,), generator=self.generator))

    # -- run ----------------------------------------------------------------------
    def run(self, dataset) -> None:
        """Main entry (reference: Trainer.py:225-259)."""
        if self.output_dir is None and self.is_writer:
            self.output_dir = Directories.output_dir(type(self.model).__name__,
                                                     self.MODEL_NAME)
        if self.world_size > 1:
            chosen = [None if self.output_dir is None
                      else str(self.output_dir)]
            dist.broadcast_object_list(chosen, src=0)
            self.output_dir = Path(chosen[0])
        Logger.info(f'training output dir: {self.output_dir}')
        if self._config is not None and self.is_writer:
            save_config(self._config, self.output_dir / 'training_config.yaml')
        if self.device.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(self.device)
        if self.WANDB.get('ACTIVATE', False) and self._wandb is None \
                and self.is_writer:
            from nerficg_torch.core.wandb_utils import WandbSession
            self._wandb = WandbSession(
                config=self._config.to_dict() if self._config else {},
                project=self.WANDB.get('PROJECT', 'nerficg_tpu'),
                run_name=self.MODEL_NAME)

        if self.iteration == 0:
            for _, callback in gather_callbacks(self, PRE):
                with self._timer(callback.__name__):
                    callback(dataset)
        else:
            # Resume: rebuild dataset-derived state without re-initializing
            # trained parameters, then apply the loaded optimizer state.
            self.on_resume(dataset)
            self._apply_pending_resume()

        main_callbacks = gather_callbacks(self, MAIN)
        num_iterations = int(self.NUM_ITERATIONS)
        # TIMING.PROFILE: the first traced iteration; the trace covers
        # PROFILE_STEPS iterations or ends with the loop.
        profile_at = self.TIMING.get('PROFILE', None) \
            if self.is_writer else None
        profile_end = None if profile_at is None else \
            int(profile_at) + int(self.TIMING.get('PROFILE_STEPS', 5))
        profiler = None
        try:
            for iteration in Logger.progress(
                    range(self.iteration, num_iterations), desc='training',
                    total=num_iterations):
                self.iteration = iteration
                if profile_at is not None and iteration == int(profile_at):
                    profiler = self._start_profile()
                elif profiler is not None and iteration == profile_end:
                    self._stop_profile(profiler)
                    profiler = None
                for meta, callback in main_callbacks:
                    if meta.is_due(iteration):
                        with self._timer(callback.__name__):
                            callback(dataset, iteration)
                self.model.num_iterations_trained = iteration + 1
        except KeyboardInterrupt:
            Logger.warning('training interrupted; running post-training '
                           'callbacks')
        if profiler is not None:
            self._stop_profile(profiler)

        if self.is_writer:
            self._log_memory_stats()
        for _, callback in gather_callbacks(self, POST):
            with self._timer(callback.__name__):
                callback(dataset)
        if self.TIMING.get('ACTIVATE', True) and self.is_writer:
            self._write_timings()
        if self.world_size > 1:
            dist.barrier()

    # -- profile -------------------------------------------------------------------------
    def _start_profile(self):
        """A ``torch.profiler`` window over the host and, on a card, the
        card's kernels (reference: SURVEY §5.1's profiler hook)."""
        from torch.profiler import ProfilerActivity, profile, \
            supported_activities
        activities = [ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            if ProfilerActivity.CUDA not in supported_activities():
                raise TrainerError('TRAINING.TIMING.PROFILE: this torch '
                                   'build cannot trace the card')
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        reset_counters()
        self._profile_from = self.iteration
        profiler.start()
        return profiler

    def _stop_profile(self, profiler) -> None:
        """End the window and write its Chrome trace, and its counters
        (totals and per iteration) beside it."""
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        profiler.stop()
        path = self.output_dir / 'profile' / 'trace.json'
        path.parent.mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(path))
        iterations = self.model.num_iterations_trained - self._profile_from
        totals = counters()
        (path.parent / 'counters.json').write_text(json.dumps(
            {'iterations': iterations, 'totals': totals,
             'per_iteration': {k: v / max(iterations, 1)
                               for k, v in totals.items()}}, indent=1))
        Logger.info(f'wrote profiler trace to {path}')

    # -- timing / memory ---------------------------------------------------------------
    def _timer(self, name: str):
        """The callback's timer, which opens its ``trainer/<name>`` span;
        the span alone with ``TIMING.ACTIVATE`` off."""
        if not self.TIMING.get('ACTIVATE', True):
            return span('trainer/' + name)
        if name not in self.timers:
            self.timers[name] = CallbackTimer(name, device=self.device)
        return self.timers[name]

    def _write_timings(self) -> None:
        """timings.txt (reference: Trainer.py:182-207)."""
        with open(self.output_dir / 'timings.txt', 'w') as f:
            for timer in sorted(self.timers.values(), key=lambda t: -t.total):
                f.write(timer.summary() + '\n')
            total = sum(t.total for t in self.timers.values())
            f.write(f'total: {total:.3f}s\n')

    def _log_memory_stats(self) -> None:
        """vram_stats.txt (reference: Trainer.py:209-223)."""
        with open(self.output_dir / 'vram_stats.txt', 'w') as f:
            if self.device.type != 'cuda':
                f.write(f'device {self.device}: device memory not measured\n')
                return
            f.write(f'device: {torch.cuda.get_device_name(self.device)}\n')
            f.write('peak allocated: '
                    f'{torch.cuda.max_memory_allocated(self.device) / 2**30:.3f}'
                    ' GiB\n')
            f.write('peak reserved: '
                    f'{torch.cuda.max_memory_reserved(self.device) / 2**30:.3f}'
                    ' GiB\n')
            for key, value in sorted(
                    torch.cuda.memory_stats(self.device).items()):
                f.write(f'{key}: {value}\n')

    # -- checkpoint / resume ---------------------------------------------------------
    def save_training_state(self, path: str | Path,
                            iteration: int | None = None) -> None:
        """Whole-trainer resume file (reference: Trainer.py:94-111): model
        params + buffers + optimizer state + host counters, in the npz
        checkpoint container. ``iteration`` is the first iteration to run
        after resume."""
        save_checkpoint(
            Path(path), self.model.params_tree(),
            metadata={'iteration': int(self.iteration if iteration is None
                                       else iteration),
                      'trainer': type(self).__name__,
                      'resume_state': self.get_resume_metadata()},
            extra_trees={'buffers': self.model.buffers,
                         'optimizer': self.get_optimizer_state(),
                         'rng': self.generator.get_state().numpy()})

    def load_training_state(self, path: str | Path) -> None:
        """Restore params and buffers now; the optimizer state and host
        counters are applied in ``run()`` after ``on_resume``."""
        payload = load_checkpoint(path)
        meta = payload['metadata']
        self.iteration = int(meta['iteration'])
        self.model.num_iterations_trained = self.iteration
        self.model.load_params_tree(payload['params'])
        self.model.buffers = {
            key: torch.as_tensor(value, device=self.device)
            for key, value in payload['extra'].get('buffers', {}).items()}
        rng = payload['extra'].get('rng')
        if isinstance(rng, np.ndarray) and rng.size:
            self.generator.set_state(torch.from_numpy(rng.astype(np.uint8)))
        self._pending_resume = {
            'optimizer': payload['extra'].get('optimizer', {}),
            'resume_state': meta.get('resume_state', {})}

    def _apply_pending_resume(self) -> None:
        pending = getattr(self, '_pending_resume', None)
        if pending is None:
            return
        self.set_resume_metadata(pending['resume_state'] or {})
        if pending['optimizer']:
            self.set_optimizer_state(pending['optimizer'])
        self._pending_resume = None

    def on_resume(self, dataset) -> None:
        """Rebuild dataset-derived state after ``load_training_state``
        without re-initializing trained parameters; methods override."""

    def get_resume_metadata(self) -> dict:
        return {}

    def set_resume_metadata(self, meta: dict) -> None:
        pass

    def get_optimizer_state(self):
        return {}

    def set_optimizer_state(self, state) -> None:
        pass

    # -- built-in callbacks -----------------------------------------------------------
    @pre_training_callback(priority=5000)
    def _prepare_dataset(self, dataset) -> None:
        """Image preloading (reference: Trainer.py:122-161)."""
        if self.PRELOAD_DATASET:
            dataset.preload()

    @training_callback(priority=10, active='WANDB.ACTIVATE',
                       iteration_stride='WANDB.INTERVAL')
    def _wandb_log(self, dataset, iteration: int) -> None:
        """Interval loss logging (reference: Trainer.py:308-351)."""
        logs = getattr(self, '_last_logs', None)
        if self._wandb is not None and self._wandb.active and logs:
            self._wandb.log({k: float(v) for k, v in logs.items()},
                            step=iteration)

    @training_callback(priority=9, active='WANDB.ACTIVATE',
                       iteration_stride='WANDB.IMAGE_INTERVAL')
    def _wandb_log_images(self, dataset, iteration: int) -> None:
        """Train/validation render grids (reference: Trainer.py:308-346):
        the render beside the ground-truth image."""
        if self._wandb is None or not self._wandb.active or \
                not self.WANDB.get('LOG_IMAGES', False):
            return
        for subset, index_key, name in (
                ('train', 'INDEX_TRAINING', 'training'),
                ('val', 'INDEX_VALIDATION', 'validation')):
            views = dataset.subsets[subset]
            if not views:
                continue
            view = views[int(self.WANDB.get(index_key, 0)) % len(views)]
            panels = [self.renderer.render_image(view)['rgb'].cpu().numpy()]
            if view.rgb_data.exists():
                panels.append(np.asarray(view.rgb))
            grid = np.concatenate([np.clip(p, 0.0, 1.0) for p in panels],
                                  axis=1)
            self._wandb.log_image(name, grid, step=iteration)

    @training_callback(priority=8, active='WANDB.SWEEP_MODE.ACTIVE',
                       start_iteration='WANDB.SWEEP_MODE.START_ITERATION',
                       iteration_stride='WANDB.SWEEP_MODE.ITERATION_STRIDE')
    def _wandb_sweep_metrics(self, dataset, iteration: int) -> None:
        """Test-set PSNR/SSIM(/LPIPS) and the MipNeRF geometric-mean
        combined metric for hyperparameter sweeps (reference:
        Trainer.py:353-395); LPIPS joins it where ``lpips_available``."""
        views = dataset.subsets['test']
        writer, world = process_index() == 0, process_count()
        indices = None
        if writer:
            if self._wandb is None or not self._wandb.active:
                Logger.warning('sweep mode requires wandb; skipping test '
                               'metrics')
            elif views:
                indices = list(range(len(views)))
                cap = int(self.WANDB['SWEEP_MODE'].get('NUM_IMAGES', 0))
                if 0 < cap < len(indices):
                    indices = random.sample(indices, k=cap)
        if world > 1:
            chosen = [indices]
            dist.broadcast_object_list(chosen, src=0)
            indices = chosen[0]
        if indices is None:
            return
        from nerficg_torch.optim.metrics import (lpips, lpips_available,
                                                 psnr, ssim)

        def score(i, view):
            pred = torch.clamp(self.renderer.render_image(view)['rgb'],
                               0.0, 1.0).cpu()
            gt = view.rgb
            if view.alpha_data.exists():
                alpha = view.alpha
                gt = gt * alpha + view.camera.background_color * (1.0 - alpha)
            gt = torch.as_tensor(gt, dtype=torch.float32)
            return (float(psnr(pred, gt)), float(ssim(pred, gt)),
                    lpips(pred, gt, device=self.device)
                    if lpips_available() else None)

        scores = list(self.renderer.mesh.gather_map(
            score, [views[i] for i in indices]))
        if not writer:
            return
        psnrs = [p for p, _, _ in scores]
        ssims = [s for _, s, _ in scores]
        lpipss = [x for _, _, x in scores if x is not None]
        m_psnr = sum(psnrs) / len(psnrs)
        m_ssim = sum(ssims) / len(ssims)
        m_lpips = sum(lpipss) / len(lpipss) if lpipss else float('nan')
        terms = [-0.1 * math.log(10.0) * m_psnr,
                 math.log(math.sqrt(max(1.0 - m_ssim, 1e-12)))]
        if lpipss:
            terms.append(math.log(max(m_lpips, 1e-12)))
        combined = math.exp(sum(terms) / len(terms))
        self._wandb.log({'test_psnr': m_psnr, 'test_ssim': m_ssim,
                         'test_lpips': m_lpips,
                         'combined_metrics': combined}, step=iteration)

    @post_training_callback(priority=100)
    def _wandb_finish(self, dataset) -> None:
        if self._wandb is not None:
            self._wandb.finish()

    @training_callback(priority=6, active='CHECKPOINT.INTERVAL',
                       start_iteration='CHECKPOINT.INTERVAL',
                       iteration_stride='CHECKPOINT.INTERVAL')
    def _periodic_checkpoint(self, dataset, iteration: int) -> None:
        """Intermediate model checkpoints (reference: Trainer.py:163-171)."""
        if self.is_writer:
            self.model.save(self.output_dir / 'checkpoints' /
                            f'{iteration:07d}.ckpt')

    @training_callback(priority=5, active='BACKUP.INTERVAL',
                       start_iteration='BACKUP.INTERVAL',
                       iteration_stride='BACKUP.INTERVAL')
    def _periodic_backup(self, dataset, iteration: int) -> None:
        """Whole-training-state backup for lossless resume (reference:
        Trainer.py:94-111, 172-180). This iteration's step already ran
        (priority 100 > 5), so resume starts at the next one."""
        if self.is_writer:
            self.save_training_state(self.output_dir / 'latest.train',
                                     iteration=iteration + 1)

    @post_training_callback(priority=1000)
    def _save_final_checkpoint(self, dataset) -> None:
        """(reference: Trainer.py:163-180)"""
        if self.CHECKPOINT.get('FINAL', True) and self.is_writer:
            self.model.save(self.output_dir / 'checkpoints' / 'final.ckpt')
            Logger.info('saved final checkpoint')

    @post_training_callback(priority=500)
    def _render_testset(self, dataset) -> None:
        """Render and score the test set (reference: Trainer.py:379-394)."""
        if self.RENDER_TESTSET and dataset.subsets['test']:
            self.test_metrics = self.renderer.render_subset(
                dataset, 'test', compute_metrics=True,
                output_dir=self.output_dir / 'test' if self.is_writer
                else None)


def adam_state_to_numpy(optimizer: torch.optim.Adam, named_params,
                        step: int) -> dict:
    """An Adam optimizer's moments by parameter name, and its step
    count, as numpy arrays for the npz resume file."""
    state = {'step': np.asarray(step, np.int64), 'exp_avg': {},
             'exp_avg_sq': {}}
    for name, p in named_params:
        s = optimizer.state.get(p)
        if s:
            state['exp_avg'][name] = s['exp_avg'].detach().cpu().numpy()
            state['exp_avg_sq'][name] = s['exp_avg_sq'].detach().cpu().numpy()
    return state


def adam_state_from_numpy(optimizer: torch.optim.Adam, named_params,
                          state: dict) -> int:
    """Load ``adam_state_to_numpy``'s arrays into ``optimizer``; returns
    the step count."""
    step = int(np.asarray(state['step']))
    for name, p in named_params:
        if name in state.get('exp_avg', {}):
            optimizer.state[p] = {
                'step': torch.tensor(float(step)),
                'exp_avg': torch.as_tensor(state['exp_avg'][name],
                                           device=p.device),
                'exp_avg_sq': torch.as_tensor(state['exp_avg_sq'][name],
                                              device=p.device)}
    return step

