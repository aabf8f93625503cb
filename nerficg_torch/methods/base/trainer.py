"""Training engine: a callback-scheduled host loop around the method's step.

Port of nerficg_tpu/methods/base/trainer.py (reference: ``BaseTrainer``,
src/Methods/Base/Trainer.py:31-395). Pre-training callbacks set up, one
training callback per iteration steps the model, post-training callbacks save
the final checkpoint and render the test set. Every callback is timed into
``timings.txt``; device memory goes to ``vram_stats.txt``. The resume file is
the npz checkpoint container with the optimizer state as numpy arrays.

Not ported: wandb logging and ``TIMING.PROFILE`` traces (both raise when
switched on).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from nerficg_torch.core.checkpoint import load_checkpoint, save_checkpoint
from nerficg_torch.core.config import ConfigNode, Configurable, save_config
from nerficg_torch.core.errors import TrainerError
from nerficg_torch.core.logging import Logger
from nerficg_torch.core.setup import Directories
from nerficg_torch.methods.base.callbacks import (MAIN, POST, PRE,
                                                  CallbackTimer,
                                                  gather_callbacks,
                                                  post_training_callback,
                                                  pre_training_callback,
                                                  training_callback)
from nerficg_torch.methods.base.model import BaseModel
from nerficg_torch.methods.base.renderer import BaseRenderer

__all__ = ['BaseTrainer']


@Configurable.configure(
    MODEL_NAME='run',
    NUM_ITERATIONS=10000,
    LOAD_CHECKPOINT=None,
    CHECKPOINT={'INTERVAL': None, 'FINAL': True},
    BACKUP={'INTERVAL': None},
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

    def __init__(self, config: ConfigNode | None, model: BaseModel,
                 renderer: BaseRenderer):
        super().__init__(config, 'TRAINING')
        if self.WANDB.get('ACTIVATE', False):
            raise TrainerError('TRAINING.WANDB.ACTIVATE is not ported yet')
        if self.TIMING.get('PROFILE', None) is not None:
            raise TrainerError('TRAINING.TIMING.PROFILE is not ported yet')
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

    def next_seed(self) -> int:
        """A fresh uint32 seed from the trainer's generator."""
        return int(torch.randint(0, 2 ** 32, (1,), generator=self.generator))

    # -- run ----------------------------------------------------------------------
    def run(self, dataset) -> None:
        """Main entry (reference: Trainer.py:225-259)."""
        if self.output_dir is None:
            self.output_dir = Directories.output_dir(type(self.model).__name__,
                                                     self.MODEL_NAME)
        Logger.info(f'training output dir: {self.output_dir}')
        if self._config is not None:
            save_config(self._config, self.output_dir / 'training_config.yaml')
        if self.device.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(self.device)

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
        try:
            for iteration in Logger.progress(
                    range(self.iteration, num_iterations), desc='training',
                    total=num_iterations):
                self.iteration = iteration
                for meta, callback in main_callbacks:
                    if meta.is_due(iteration):
                        with self._timer(callback.__name__):
                            callback(dataset, iteration)
                self.model.num_iterations_trained = iteration + 1
        except KeyboardInterrupt:
            Logger.warning('training interrupted; running post-training '
                           'callbacks')

        self._log_memory_stats()
        for _, callback in gather_callbacks(self, POST):
            with self._timer(callback.__name__):
                callback(dataset)
        if self.TIMING.get('ACTIVATE', True):
            self._write_timings()

    # -- timing / memory ---------------------------------------------------------------
    def _timer(self, name: str):
        if not self.TIMING.get('ACTIVATE', True):
            return _NullTimer()
        if name not in self.timers:
            self.timers[name] = CallbackTimer(
                name, sample_every=int(self.TIMING.get('SAMPLE_EVERY', 16)),
                device=self.device)
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

    @training_callback(priority=6, active='CHECKPOINT.INTERVAL',
                       start_iteration='CHECKPOINT.INTERVAL',
                       iteration_stride='CHECKPOINT.INTERVAL')
    def _periodic_checkpoint(self, dataset, iteration: int) -> None:
        """Intermediate model checkpoints (reference: Trainer.py:163-171)."""
        self.model.save(self.output_dir / 'checkpoints' / f'{iteration:07d}.ckpt')

    @training_callback(priority=5, active='BACKUP.INTERVAL',
                       start_iteration='BACKUP.INTERVAL',
                       iteration_stride='BACKUP.INTERVAL')
    def _periodic_backup(self, dataset, iteration: int) -> None:
        """Whole-training-state backup for lossless resume (reference:
        Trainer.py:94-111, 172-180). This iteration's step already ran
        (priority 100 > 5), so resume starts at the next one."""
        self.save_training_state(self.output_dir / 'latest.train',
                                 iteration=iteration + 1)

    @post_training_callback(priority=1000)
    def _save_final_checkpoint(self, dataset) -> None:
        """(reference: Trainer.py:163-180)"""
        if self.CHECKPOINT.get('FINAL', True):
            self.model.save(self.output_dir / 'checkpoints' / 'final.ckpt')
            Logger.info('saved final checkpoint')

    @post_training_callback(priority=500)
    def _render_testset(self, dataset) -> None:
        """Render and score the test set (reference: Trainer.py:379-394)."""
        if self.RENDER_TESTSET and dataset.subsets['test']:
            self.test_metrics = self.renderer.render_subset(
                dataset, 'test', output_dir=self.output_dir / 'test',
                compute_metrics=True)


class _NullTimer:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
