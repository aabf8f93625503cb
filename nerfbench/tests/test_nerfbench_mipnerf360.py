"""The ``mip360_train`` cell at a tiny size on the CPU: a sound run is
correct; the lower-precision control, a state left unchanged, half of the
batch left out and the NeRF round's colour altered are not; a traced run
reports the contraction's share from the program's counter, and the other
new metrics read the window's trace and work; the reference turns TF32
off."""

import pytest
import torch

from nerfbench import calibrate, check
from nerfbench.run import run_cell
from nerfbench.spec import Cell

SEED = 2 ** 31 + 12345


def tiny_cell() -> Cell:
    """The cell cut to a CPU test's size: 4 views of 64 x 48, 64 rays, a
    2 x 16 proposal MLP and a 3 x 32 NeRF MLP, 8 + 8 / 4 samples."""
    cell = Cell('mip360_train')
    cell.config['scene'].update(views=4, width=64, height=48)
    cell.config['reference_block'] = 32
    port = cell.config['port_config']
    port['MODEL'].update(PROPOSAL_LAYERS=2, PROPOSAL_WIDTH=16, NUM_LAYERS=3,
                         WIDTH=32, SKIP_LAYER=2, BOTTLENECK_WIDTH=16,
                         VIEW_WIDTH=16)
    port['RENDERER'].update(PROPOSAL_SAMPLES=[8, 8], NERF_SAMPLES=4)
    port['TRAINING']['RAYS_PER_BATCH'] = 64
    return cell


def _run(cell, trace=False):
    return run_cell(cell, SEED, 0.5, trace, device='cpu', start=0.0)


def test_sound_run_is_correct_and_traced():
    result = _run(tiny_cell(), trace=True)
    assert result['correct'], result['check']
    metrics = result['metrics']
    # the CPU has no device trace: only the counter and the FLOP share
    assert set(metrics) == {'mip_contracted_pct.train', 'mip_mfu_pct.train'}
    assert 0.0 < metrics['mip_contracted_pct.train']['value'] < 100.0


def test_control_and_half_batch_fail():
    cell = tiny_cell()
    readings = calibrate.train_readings(cell, SEED, True, 'cpu')
    by_kind = {r['kind']: r for r in readings}
    assert check.judge(by_kind['program'], cell.limits)[0]
    assert not check.judge(by_kind['control'], cell.limits)[0]
    assert not check.judge(by_kind['fault_half_batch'], cell.limits)[0]


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, 'step', lambda self, *a, **k: None)


def _half_batch(monkeypatch):
    from nerficg_torch.methods.mipnerf360.trainer import MipNeRF360Trainer
    original = MipNeRF360Trainer.loss_and_grads
    monkeypatch.setattr(MipNeRF360Trainer, 'loss_and_grads',
                        lambda self, ids, draws=None: original(
                            self, ids[:ids.shape[0] // 2], draws))


def _colour_altered(monkeypatch):
    from nerficg_torch.methods.mipnerf360.model import MipNeRF360Model
    original = MipNeRF360Model.field
    monkeypatch.setattr(MipNeRF360Model, 'field',
                        lambda self, f, d: (lambda out: (
                            out[0], 1.0 - out[1]))(original(self, f, d)))


@pytest.mark.parametrize('fault', [_state_unchanged, _half_batch,
                                   _colour_altered],
                         ids=['state_unchanged', 'half_batch',
                              'colour_altered'])
def test_broken_path_is_not_correct(fault, monkeypatch):
    cell = tiny_cell()
    fault(monkeypatch)
    result = _run(cell)
    assert not result['correct'], result['check']


def test_step_flops_count_both_mlps():
    cell = Cell('mip360_train')
    flops = cell.method.step_flops(cell.config)
    # 6 x (215,296 MACs x 2^14 x 128 + 7,787,264 MACs x 2^14 x 32)
    assert flops == 6.0 * (215296 * 16384 * 128 + 7787264 * 16384 * 32)


def test_reference_turns_tf32_off(monkeypatch):
    from nerfbench.methods.MipNeRF360 import _weights
    from nerfbench.reference import mipnerf360 as ref
    cell = tiny_cell()
    port = cell.config['port_config']
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', True)
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', True)
    rays = 8
    out = ref.render_rays(
        _weights(cell.config, 1, 'cpu'), torch.zeros(rays, 3),
        torch.nn.functional.normalize(torch.ones(rays, 3), dim=-1),
        torch.full((rays,), 1e-3), [torch.rand(rays) for _ in range(3)],
        port['MODEL'], port['RENDERER'], torch.bfloat16)
    assert out['rgb'].shape == (rays, 3)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
