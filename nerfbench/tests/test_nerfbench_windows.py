"""The windows end at a whole step or frame, and each rate is taken over
all the work and all the time of its window."""

import time
import types

import numpy as np
import pytest

from nerfbench.drivers import render, train


class _Trainer:
    """The parts of a trainer the training loop drives."""

    def __init__(self, step_s):
        from nerficg_torch.methods.base.callbacks import training_callback
        self.step_s, self.done = step_s, 0
        self.model = types.SimpleNamespace(num_iterations_trained=0)
        self.iteration = 0

        class Owner:
            @training_callback(priority=100)
            def training_iteration(me, dataset, iteration):
                time.sleep(self.step_s)
                self.done += 1
        self._owner = Owner()

    def _timer(self, name):
        import contextlib
        return contextlib.nullcontext()


def test_training_window_ends_at_whole_steps(monkeypatch):
    from nerficg_torch.methods.base import callbacks
    fake = _Trainer(0.02)
    session = types.SimpleNamespace(trainer=fake, dataset=None,
                                    record=lambda step: None,
                                    records=lambda: {})
    method = types.SimpleNamespace(build_train=lambda *a: session)
    monkeypatch.setattr(callbacks, 'gather_callbacks',
                        lambda trainer, kind: _gather(fake._owner, kind))
    run = train.Train(method, {}, {'start_iteration': 7, 'warmup_steps': 2},
                      0, 'cpu')
    assert fake.done == 2
    out = run.window(0.25)
    steps = len(out['units'])
    assert fake.done == 2 + steps
    assert out['units'] == list(range(2, 2 + steps))
    assert out['elapsed_s'] >= 0.25
    assert out['metrics']['train_it_per_s'] == \
        pytest.approx(steps / out['elapsed_s'])
    assert steps * 0.02 <= out['elapsed_s'] + 1e-3
    assert fake.model.num_iterations_trained == 7 + 2 + steps


def _gather(owner, kind):
    from nerficg_torch.methods.base.callbacks import CallbackMeta
    fn = type(owner).training_iteration
    meta: CallbackMeta = fn.__callback_meta__
    return [(meta.resolve(owner), owner.training_iteration)] \
        if meta.callback_type == kind else []


def test_serving_window_ends_at_whole_frames():
    delays = iter(np.tile([0.004, 0.006, 0.02], 1000))
    served = []

    class Session:
        views = list(range(5))

        def render(self, view):
            time.sleep(next(delays))
            served.append(view)
            return view
    method = types.SimpleNamespace(build_render=lambda *a: Session())
    run = render.Render(method, {}, {'check_frames': 2}, 3, 'cpu')
    assert served == list(range(5))
    out = run.window(0.3)
    frames = len(out['units'])
    assert served[5:] == out['units'] == [i % 5 for i in range(frames)]
    assert out['elapsed_s'] >= 0.3
    assert out['metrics']['render_fps'] == \
        pytest.approx(frames / out['elapsed_s'])
    # every third frame takes 20 ms: the 95th percentile sees them
    assert out['metrics']['frame_ms_p95'] >= 19.0
    assert sorted(run.records()['frames']) == run.sample


def test_a_window_short_of_the_sample_keeps_its_first_frame():
    """A window that serves fewer poses than the sample spans still keeps
    the first pose's frame, which every window serves first."""
    class Session:
        views = list(range(100))

        def render(self, view):
            time.sleep(0.05)
            return view
    method = types.SimpleNamespace(build_render=lambda *a: Session())
    run = render.Render(method, {}, {'check_frames': 6}, 7, 'cpu')
    assert run.sample[0] == 0 and len(set(run.sample)) == 6
    assert run.sample == render.sampled_poses(7, 100, 6)
    out = run.window(0.01)
    assert out['units'][0] == 0
    assert 0 in run.records()['frames']
