"""The training entry: the trainer's per-iteration loop as
``BaseTrainer.run`` drives it.

Set-up builds one trainer (the method adapter's ``build_train``), runs
its pre-training callbacks when it starts at iteration 0 (a later start is
a resume, which the adapter has applied), then drives ``warmup_steps``
iterations through the same loop the window runs: the first three are the
steps the reference follows. The window then runs whole iterations until
``seconds`` have passed on the host's clock and waits for the card: the
rate is iterations over the window's whole time.
"""

from __future__ import annotations

import time

import torch

from nerfbench.trace import WINDOW_SPAN

__all__ = ['Train']

CHECKED_STEPS = 3


class Train:

    def __init__(self, method, cfg: dict, traffic: dict, seed: int,
                 device) -> None:
        from nerficg_torch.methods.base.callbacks import (MAIN, PRE,
                                                          gather_callbacks)
        self.session = method.build_train(cfg, traffic, seed, device)
        self.trainer = trainer = self.session.trainer
        self.dataset = self.session.dataset
        self.device = device
        self.iteration = int(traffic['start_iteration'])
        if self.iteration == 0:
            for _, callback in gather_callbacks(trainer, PRE):
                with trainer._timer(callback.__name__):
                    callback(self.dataset)
        self.main = gather_callbacks(trainer, MAIN)
        self.steps = 0
        for step in range(1, int(traffic['warmup_steps']) + 1):
            self._iterate()
            if step <= CHECKED_STEPS:
                self.session.record(step)
        _sync(device)

    def _iterate(self) -> None:
        """One iteration: the due main callbacks by priority, each under
        the trainer's timer, as ``BaseTrainer.run`` calls them."""
        trainer, it = self.trainer, self.iteration
        trainer.iteration = it
        for meta, callback in self.main:
            if meta.is_due(it):
                with trainer._timer(callback.__name__):
                    callback(self.dataset, it)
        trainer.model.num_iterations_trained = it + 1
        self.iteration += 1
        self.steps += 1

    def window(self, seconds: float) -> dict:
        from torch.profiler import record_function
        first = self.steps
        with record_function(WINDOW_SPAN):
            start = time.perf_counter()
            while time.perf_counter() - start < seconds:
                self._iterate()
            _sync(self.device)
            elapsed = time.perf_counter() - start
        done = self.steps - first
        return {'metrics': {'train_it_per_s': done / elapsed},
                'units': list(range(first, self.steps)),
                'elapsed_s': elapsed}

    def records(self) -> dict:
        return self.session.records()

    def close(self) -> None:
        self.session = self.trainer = self.dataset = self.main = None


def _sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)
