"""The plain reference against the port's CPU path at a tiny size, and the
comparison that decides ``correct`` shown to fail: the lower-precision
control, and a run driven with its timed path broken underneath (a step
that leaves the state unchanged, half of the batch left out, an answer
altered where it is produced)."""

import pytest
import torch

from nerfbench import calibrate, check
from nerfbench.run import run_cell
from tiny import tiny_cell

CELLS = ['gs360_train', 'nerf_train', 'gs360_render_1080p']
SEED = 2 ** 31 + 12345


def _run(cell):
    return run_cell(cell, SEED, 0.5, False, device='cpu', start=0.0)


@pytest.mark.parametrize('name', CELLS)
def test_sound_run_is_correct(name):
    result = _run(tiny_cell(name))
    assert result['correct'], result['check']
    assert result['attempted'] > 0 and result['failed'] == 0
    assert list(result)[-1] == 'check'
    for entry in result['check'].values():
        assert entry['value'] <= entry['limit']


@pytest.mark.parametrize('name', ['gs360_train', 'nerf_train'])
def test_control_fails(name):
    """The reference computed in the next precision below the
    configuration's, put in the program's place."""
    cell = tiny_cell(name)
    readings = calibrate.train_readings(cell, SEED, True, 'cpu')
    control = next(r for r in readings if r['kind'] == 'control')
    program = next(r for r in readings if r['kind'] == 'program')
    assert check.judge(program, cell.limits)[0]
    assert not check.judge(control, cell.limits)[0], control


def test_render_control_fails():
    cell = tiny_cell('gs360_render_1080p')
    readings = calibrate.render_readings(cell, SEED, True, 0.5, 'cpu')
    control = next(r for r in readings if r['kind'] == 'control')
    assert not check.judge(control, cell.limits)[0], control


@pytest.mark.parametrize('name', ['gs360_train', 'nerf_train'])
def test_rows_seen_twice_are_correct_too(name, monkeypatch):
    """``trainer_seed`` moves RANDOM_SEED to one whose checked steps see
    rows that all differ; with it held at a seed whose steps see a view
    or a ray twice, the program and the reference agree all the same."""
    from nerfbench.common import rows_differ
    cell = tiny_cell(name)
    s = cell.config['scene']
    if cell.config['method'] == 'GaussianSplatting':
        draws, pool = 1, s['views']
    else:
        draws = cell.config['port_config']['TRAINING']['RAYS_PER_BATCH']
        pool = s['views'] * s['width'] * s['height']
    seed = next(x for x in range(SEED % 2 ** 32, SEED % 2 ** 32 + 1000)
                if not rows_differ(x, draws, pool))
    monkeypatch.setattr(cell.method, 'trainer_seed', lambda *a, **k: seed)
    result = _run(cell)
    assert result['correct'], result['check']


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, 'step', lambda self, *a, **k: None)


def _half_batch_gs(monkeypatch):
    from nerficg_torch.methods.gaussian_splatting import trainer
    for name in ('l1', 'dssim'):
        fn = getattr(trainer, name)
        monkeypatch.setattr(trainer, name, lambda p, t, fn=fn: fn(
            p[:p.shape[0] // 2], t[:t.shape[0] // 2]))


def _half_batch_nerf(monkeypatch):
    from nerficg_torch.methods.nerf.trainer import NeRFTrainer
    original = NeRFTrainer.loss_and_grads
    monkeypatch.setattr(NeRFTrainer, 'loss_and_grads',
                        lambda self, ids, draws=None: original(
                            self, ids[:ids.shape[0] // 2], draws))


def _altered_frame(monkeypatch):
    from nerficg_torch.methods.gaussian_splatting.renderer import \
        GaussianSplattingRenderer
    original = GaussianSplattingRenderer.render_image

    def altered(self, view, benchmark=False):
        out = original(self, view, benchmark)
        rgb = out['rgb'].clone()
        rgb[:16, :16] = 1.0 - rgb[:16, :16]
        return dict(out, rgb=rgb)
    monkeypatch.setattr(GaussianSplattingRenderer, 'render_image', altered)


@pytest.mark.parametrize('name, fault', [
    ('gs360_train', _state_unchanged), ('nerf_train', _state_unchanged),
    ('gs360_train', _half_batch_gs), ('nerf_train', _half_batch_nerf),
    ('gs360_render_1080p', _altered_frame)],
    ids=['gs_state_unchanged', 'nerf_state_unchanged', 'gs_half_batch',
         'nerf_half_batch', 'render_answer_altered'])
def test_broken_path_is_not_correct(name, fault, monkeypatch):
    cell = tiny_cell(name)
    fault(monkeypatch)
    result = _run(cell)
    assert not result['correct'], result['check']
    assert result['failed'] == result['attempted']


@pytest.mark.cuda
@pytest.mark.parametrize('name', CELLS)
def test_cell_on_the_card(name, card):
    """One short run of each cell at its full size, judged as the check
    judges it."""
    result = run_cell(name, SEED, 2.0, False, device=card)
    assert result['correct'], result['check']
    assert result['device']['platform'] == 'gpu'
    assert 'setup_s' in result['metrics']


def test_numbers_that_are_not_finite_fail_and_print_as_text():
    import json
    import math
    ok, shown = check.judge({'a': 1e-9, 'b': math.inf, 'c': math.nan},
                            {'a': 1.0, 'b': 1.0, 'c': 1.0, 'd': 1.0})
    assert not ok
    assert shown['a']['value'] == 1e-9
    assert [shown[k]['value'] for k in 'bcd'] == ['inf', 'nan', 'inf']
    json.loads(json.dumps(shown, allow_nan=False))
    assert not check.judge({}, {})[0]
