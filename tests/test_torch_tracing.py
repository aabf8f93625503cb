"""The port's spans and counters (``nerficg_torch/core/tracing.py``) and
the trainer's timer, on the CPU.

* With no profiler recording, a span never enters ``record_function`` and
  a count keeps nothing; under a CPU ``torch.profiler`` the ``nerficg/``
  ranges nest as the code does, and counters add up and reset.
* ``BaseTrainer._timer`` opens the ``trainer/<callback>`` span, with and
  without ``TIMING.ACTIVATE``; ``CallbackTimer`` on the CPU keeps the
  host's clock and its ``timings.txt`` line.
* A 3DGS training step, a 3DGS served frame, a NeRF and a Mip-NeRF 360
  training step open their layers' spans under the callback's, and count
  what their rasterizer or sampler made: equal to the same call's own
  outputs. Without a profiler Mip-NeRF 360's step hands its counters no
  tensor to reduce.
* Marked ``cuda``: on a card ``CallbackTimer`` waits for it at no call,
  and its total is the card's time over the calls. Without a card it
  skips; on one (no JAX needed):
  ``python -m pytest --noconftest tests/test_torch_tracing.py -m cuda``.
"""

import types

import pytest
import torch
from torch.profiler import profile

from nerficg_torch.core import tracing
from nerficg_torch.core.config import ConfigNode
from nerficg_torch.core.logging import Logger
from nerficg_torch.core.registry import Datasets, Methods
from nerficg_torch.data.synthetic import make_textured_scene
from nerficg_torch.methods.base.callbacks import PRE, CallbackTimer, \
    gather_callbacks
from nerficg_torch.methods.base.trainer import BaseTrainer
from nerficg_torch.ops.gs_rasterize import rasterize_gaussians
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

Logger.set_level('SILENT')


@pytest.fixture(autouse=True)
def fresh_counters():
    tracing.reset_counters()
    yield
    tracing.reset_counters()


def _spans(prof) -> dict:
    """Each ``nerficg/`` range of a profile: its name without the prefix
    -> the names of the ``nerficg/`` ranges that enclose it, innermost
    first."""
    out = {}
    for event in prof.events():
        if not event.name.startswith(tracing.PREFIX):
            continue
        chain, parent = [], event.cpu_parent
        while parent is not None:
            if parent.name.startswith(tracing.PREFIX):
                chain.append(parent.name[len(tracing.PREFIX):])
            parent = parent.cpu_parent
        out.setdefault(event.name[len(tracing.PREFIX):], chain)
    return out


# -- the module ----------------------------------------------------------------

def test_without_a_profiler_no_range_and_no_count(monkeypatch):
    def refuse(name):
        raise AssertionError(f'record_function({name!r}) with tracing off')
    monkeypatch.setattr(tracing, 'record_function', refuse)

    @tracing.traced('inner')
    def inner(x):
        return x + 1

    assert not tracing.enabled()
    with tracing.span('outer'):
        assert inner(1) == 2
    assert tracing.span('a') is tracing.span('b')
    tracing.count('n', torch.tensor(3))
    tracing.count('m', 5)
    assert tracing.counters() == {}


def test_nested_spans_under_a_profiler():
    @tracing.traced('inner')
    def inner(x):
        with tracing.span('innermost'):
            return x * 2

    assert inner.__name__ == 'inner'
    with profile() as prof:
        with tracing.span('outer'):
            inner(torch.ones(3))
    assert _spans(prof) == {'outer': [], 'inner': ['outer'],
                            'innermost': ['inner', 'outer']}


def test_counters_add_up_and_reset():
    with profile():
        for i in range(3):
            tracing.count('ints', i + 1)
            tracing.count('tensors', torch.tensor(10 * (i + 1)))
            tracing.count('mixed', 1 if i else torch.tensor(100))
    tracing.count('ints', 1000)            # after the window: kept out
    assert tracing.counters() == {'ints': 6, 'tensors': 60, 'mixed': 102}
    assert all(type(v) is int for v in tracing.counters().values())
    tracing.reset_counters()
    assert tracing.counters() == {}


# -- the trainer's timer ----------------------------------------------------------

@pytest.mark.parametrize('active', [True, False])
def test_timer_opens_the_callback_span(active):
    owner = types.SimpleNamespace(TIMING={'ACTIVATE': active}, timers={},
                                  device=torch.device('cpu'))
    with profile() as prof:
        with BaseTrainer._timer(owner, 'training_iteration'):
            with tracing.span('frontend'):
                pass
    assert _spans(prof) == {'trainer/training_iteration': [],
                            'frontend': ['trainer/training_iteration']}
    assert list(owner.timers) == (['training_iteration'] if active else [])


def test_callback_timer_on_the_cpu():
    timer = CallbackTimer('step')
    for _ in range(3):
        with timer:
            sum(range(1000))
    assert timer.count == 3 and timer.total > 0.0
    assert timer.mean == pytest.approx(timer.total / 3)
    assert timer.summary().startswith(f'step: total {timer.total:.3f}s '
                                      f'over 3 calls (mean ')


# -- the methods' spans and counters ------------------------------------------

@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    return make_textured_scene(tmp_path_factory.mktemp('tracing_scene'),
                               image_size=32, n_train=4, n_test=1)


def _gs(scene):
    cfg = ConfigNode({
        'GLOBAL': {'METHOD_TYPE': 'GaussianSplatting',
                   'DATASET_TYPE': 'NeRF', 'RANDOM_SEED': 0,
                   'LOG_LEVEL': 'SILENT'},
        'DATASET': {'PATH': str(scene)},
        'MODEL': {'SH_DEGREE': 1, 'CAPACITY_GRANULARITY': 1024},
        'RENDERER': {'MAX_PER_TILE': 16},
        'TRAINING': {'RANDOM_POINTS': 2048, 'RENDER_TESTSET': False,
                     'PRELOAD_DATASET': False}})
    dataset = Datasets.get_dataset(cfg)
    trainer = Methods.get_training_instance(cfg, device='cpu')
    trainer._setup_gaussians(dataset)
    return trainer, dataset


def test_gs_training_step_spans_and_counters(scene):
    trainer, dataset = _gs(scene)
    with profile() as prof:
        with trainer._timer('training_iteration'):
            trainer.training_iteration(dataset, 20000)
    found = tracing.counters()
    step = ['trainer/training_iteration']
    assert _spans(prof) == {'trainer/training_iteration': [],
                            'frontend': step, 'rasterizer': step,
                            'composite': ['rasterizer'] + step,
                            'loss': step, 'optimizer': step}
    assert set(found) == {'gs/entries', 'gs/entries_past_k',
                          'gs/gaussians_past_d'}
    # the budget of 16 entries a tile truncates this scene
    assert 0 < found['gs/entries_past_k'] < found['gs/entries']
    assert 0 <= found['gs/gaussians_past_d'] <= 2048


def test_gs_served_frame_counts_its_own_stream(scene):
    """The counters of a served frame equal the counts of the same
    frontend and rasterizer call, made again with tracing off."""
    trainer, dataset = _gs(scene)
    renderer = trainer.renderer
    view = dataset.subsets['train'][1]
    with profile() as prof:
        renderer.render_image(view)
    assert _spans(prof) == {'render_image': [], 'frontend': ['render_image'],
                            'rasterizer': ['render_image'],
                            'composite': ['rasterizer', 'render_image']}
    found = tracing.counters()
    tracing.reset_counters()
    intrinsics, w2c, cam_pos = renderer.view_constants(view)
    model = renderer.model
    with torch.no_grad():
        inputs = renderer.frontend(model.params, w2c, cam_pos, intrinsics,
                                   int(model.active_sh_degree))
        out = rasterize_gaussians(
            **inputs, width=intrinsics[4], height=intrinsics[5],
            background=torch.zeros(3),
            max_tiles_per_gaussian=int(renderer.MAX_TILES_PER_GAUSSIAN),
            max_per_tile=int(renderer.MAX_PER_TILE), packed_inference=True)
    assert tracing.counters() == {}
    assert found == {
        'gs/entries': int(out['counts'].sum()),
        'gs/entries_past_k': int(out['overflow_entries']),
        'gs/gaussians_past_d': int(out['overflow_gaussians'])}
    assert found['gs/entries_past_k'] == int(
        torch.clamp(out['counts'] - int(renderer.MAX_PER_TILE), min=0).sum())


def test_gs_step_without_a_profiler_counts_nothing(scene, monkeypatch):
    trainer, dataset = _gs(scene)
    monkeypatch.setattr(tracing, 'record_function', None)
    with trainer._timer('training_iteration'):
        trainer.training_iteration(dataset, 20000)
    assert tracing.counters() == {}


def test_nerf_training_step_spans_and_samples(scene):
    cfg = ConfigNode({
        'GLOBAL': {'METHOD_TYPE': 'NeRF', 'DATASET_TYPE': 'NeRF',
                   'RANDOM_SEED': 0, 'LOG_LEVEL': 'SILENT'},
        'DATASET': {'PATH': str(scene)},
        'MODEL': {'NUM_LAYERS': 2, 'WIDTH': 32, 'SKIP_LAYER': 1,
                  'USE_COARSE': True},
        'RENDERER': {'N_SAMPLES': 24, 'COARSE_RATIO': 0.25},
        'TRAINING': {'RAYS_PER_BATCH': 64, 'RENDER_TESTSET': False}})
    dataset = Datasets.get_dataset(cfg)
    trainer = Methods.get_training_instance(cfg, device='cpu')
    for _, callback in gather_callbacks(trainer, PRE):
        callback(dataset)
    with profile() as prof:
        with trainer._timer('training_iteration'):
            trainer.training_iteration(dataset, 0)
    step = ['trainer/training_iteration']
    assert _spans(prof) == {'trainer/training_iteration': [],
                            'sampler': step, 'field': step,
                            'compositor': step, 'loss': step,
                            'optimizer': step}
    # 6 coarse samples a ray, then the 6 merged with 18 fine ones
    assert tracing.counters() == {'nerf/samples': 64 * (6 + 24)}


def _mip(scene):
    cfg = ConfigNode({
        'GLOBAL': {'METHOD_TYPE': 'MipNeRF360', 'DATASET_TYPE': 'NeRF',
                   'RANDOM_SEED': 0, 'LOG_LEVEL': 'SILENT'},
        'DATASET': {'PATH': str(scene)},
        'MODEL': {'PROPOSAL_LAYERS': 2, 'PROPOSAL_WIDTH': 16,
                  'NUM_LAYERS': 3, 'WIDTH': 32, 'SKIP_LAYER': 2,
                  'BOTTLENECK_WIDTH': 16, 'VIEW_WIDTH': 16},
        'RENDERER': {'PROPOSAL_SAMPLES': [8, 8], 'NERF_SAMPLES': 4},
        'TRAINING': {'RAYS_PER_BATCH': 64, 'RENDER_TESTSET': False}})
    dataset = Datasets.get_dataset(cfg)
    trainer = Methods.get_training_instance(cfg, device='cpu')
    for _, callback in gather_callbacks(trainer, PRE):
        callback(dataset)
    return trainer, dataset


def test_mipnerf360_training_step_spans_and_counters(scene):
    """The step opens every layer's span under the callback's; the NeRF
    samples outside the unit ball count as the same step's frustum means,
    made again with tracing off, put them."""
    from nerficg_torch.ops.frustum import conical_frustum_gaussians
    from nerficg_torch.ops.sampling import s_to_t
    trainer, dataset = _mip(scene)
    renderer, pool = trainer.renderer, trainer._pool
    ids = torch.arange(0, 64 * 61, 61)
    draws = [torch.rand(64, generator=torch.Generator().manual_seed(k))
             for k in range(3)]
    rays = (pool['origins'][ids], pool['directions'][ids], pool['radii'][ids])
    with torch.no_grad():
        out = renderer._render_rays_impl(*rays, draws=draws)
    s = out['rounds'][-1]['edges']
    t = s_to_t(s, renderer.NEAR_PLANE, renderer.FAR_PLANE)
    means, _ = conical_frustum_gaussians(*rays, t[:, :-1], t[:, 1:])
    outside = int(((means * means).sum(-1) > 1.0).sum())
    assert tracing.counters() == {}
    with profile() as prof:
        with trainer._timer('training_iteration'):
            trainer.train_step(ids, draws)
    step = ['trainer/training_iteration']
    assert _spans(prof) == {'trainer/training_iteration': [],
                            'sampler': step, 'encoding': step,
                            'proposal': step, 'compositor': step,
                            'field': step, 'loss': step, 'optimizer': step}
    assert tracing.counters() == {'mip/samples': 64 * (8 + 8 + 4),
                                  'mip/contracted': outside}
    assert 0 < outside < 64 * 4


def test_mipnerf360_step_without_a_profiler_reduces_nothing(scene,
                                                            monkeypatch):
    """With tracing off no span enters ``record_function`` and no counter
    is handed a tensor, so nothing is reduced or read for them."""
    from nerficg_torch.methods.mipnerf360 import renderer as mip_renderer
    trainer, dataset = _mip(scene)
    handed = []
    monkeypatch.setattr(tracing, 'record_function', None)
    monkeypatch.setattr(mip_renderer, 'count',
                        lambda name, value: handed.append((name, value)))
    with trainer._timer('training_iteration'):
        trainer.training_iteration(dataset, 0)
    assert [name for name, _ in handed] == ['mip/samples'] * 3
    assert all(type(value) is int for _, value in handed)
    assert tracing.counters() == {}


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


@pytest.mark.cuda
def test_callback_timer_waits_for_the_card_at_no_call(cuda, monkeypatch):
    """64 calls, each queueing a few ms of GEMMs: no synchronise, and the
    total, read after the loop's own synchronise, within 10% of the card's
    time over the loop (a pair of events around it)."""
    a = torch.randn(2048, 2048, device=cuda)
    timer = CallbackTimer('step', device=cuda)
    with timer:
        a @ a
    torch.cuda.synchronize(cuda)
    warm = timer.total
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def refuse(*args, **kwargs):
        raise AssertionError('CallbackTimer synchronised the card')
    with monkeypatch.context() as patch:
        patch.setattr(torch.cuda, 'synchronize', refuse)
        begin.record()
        for _ in range(64):
            with timer:
                for _ in range(4):
                    a = torch.tanh(a @ a * 1e-3)
        end.record()
    torch.cuda.synchronize(cuda)
    loop_s = begin.elapsed_time(end) / 1e3
    assert timer.count == 65
    assert timer.total - warm == pytest.approx(loop_s, rel=0.1)
