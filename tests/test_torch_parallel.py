"""The port's data-parallel training (nerficg_torch/parallel) against the
JAX package's, on the CPU: ranks are processes of a gloo group (started by
tests/torch_dist_ranks.py, or by torchrun for the trainer), the JAX side
runs on the virtual CPU devices of tests/conftest.py. Each counterpart of
tests/test_parallel.py's ten tests, and:

* Layout: a 1-D mesh over the 4 ranks, ``pad_divisible``, each rank's
  contiguous block of a batch (the block ``P('data')`` gives device r),
  Shard(0)/Replicate() placements, the 2-D (dcn, ici) mesh and a tensor
  split over both of its axes; the backend rule; ``initialize_distributed``
  in one process is a no-op.
* The linear model's step on 4 ranks equals the one-process step on the
  whole batch to 1e-5; parameters are equal on every rank.
* One Instant-NGP and one D-NeRF data-parallel step on 4 ranks against the
  JAX trainer's ``_build_dp_train_step`` on a 4-device mesh: the same
  parameters, grid, global ids, background and per-rank march seeds
  ``jax.random.bits(fold_in(key, r))`` (D-NeRF: each device's offset-prior
  points), exact corners. Loss to LOSS_RTOL relative; the averaged
  gradients and the parameters after Adam to FROBENIUS_RTOL relative
  Frobenius error (tests/test_torch_training.py's noise floor; JAX's
  gradients are the mean of its per-shard gradients, each shard's loss
  as its DP step computes it). After four more steps and a grid refresh
  every rank holds bit-equal parameters and grid.
* The integer logs: JAX's DP step returns device 0's block count
  (``out_specs=P()`` on a per-device value), a fault of the reference;
  the port's step returns the sum over ranks.
* The trainer: ``python -m torch.distributed.run --nproc_per_node 2 -m
  nerficg_torch.scripts.train ... GLOBAL.NUM_DEVICES=2`` against the JAX
  trainer with NUM_DEVICES=2, 100 iterations, BATCH_RESIZE_INTERVAL past
  the run (so the fault above does not enter): rank 0 alone writes one
  run directory, test PSNRs within PSNR_BAND_DB, final.ckpt loads in the
  JAX model. D-NeRF the same way for 50 iterations (a finite PSNR, its
  final.ckpt in the JAX model), running beside it.

Every launch has a deadline (RANK_TIMEOUT_S, TRAIN_TIMEOUT_S), so a
collective that never completes fails its test.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.core.config import ConfigNode as TConfigNode
from nerficg_torch.core.config import save_config
from nerficg_torch.core.errors import TrainerError
from nerficg_torch.core.logging import Logger as TLogger
from nerficg_torch.core.registry import Methods as TMethods
from nerficg_torch.data.synthetic import (make_dynamic_textured_scene,
                                          make_textured_scene)
from nerficg_torch.parallel.mesh import (choose_backend,
                                         initialize_distributed,
                                         process_count)
from nerficg_tpu.core.config import ConfigNode as JConfigNode
from nerficg_tpu.core.registry import Datasets as JDatasets
from nerficg_tpu.core.registry import Methods as JMethods
from nerficg_tpu.core.setup import Directories as JDirectories
from test_torch_training import _config, _shell_grid
from torch_dist_ranks import launch, linear_problem
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TLogger.set_level('SILENT')

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
LOSS_RTOL = 1e-5
FROBENIUS_RTOL = 2e-2
# Twice the JAX trainer's own spread over seeds 0-3 at the trainer test's
# config with NUM_DEVICES=2 and 100 iterations (22.71, 22.90, 22.43 and
# 22.74 dB: 0.47 dB); the two packages draw different march jitter.
PSNR_BAND_DB = 2 * 0.47
TRAIN_ITERATIONS = 100
TRAIN_TIMEOUT_S = 240


# -- layout and the linear step ----------------------------------------------

@pytest.fixture(scope='module')
def mesh_ranks(tmp_path_factory):
    return launch('mesh_checks', WORLD, tmp_path_factory.mktemp('mesh'))


def test_mesh_size(mesh_ranks):
    for rank, out in enumerate(mesh_ranks):
        assert out['mesh'] == (WORLD, ('data',), [rank])
        assert out['num_devices'] == WORLD


def test_render_mesh_shard_batch(mesh_ranks):
    from torch.distributed.tensor import Replicate, Shard
    x = np.arange(64.0).reshape(16, 4)
    for rank, out in enumerate(mesh_ranks):
        np.testing.assert_array_equal(out['block'], x[4 * rank:4 * rank + 4])
        assert out['placements'] == ((Shard(0),), (Replicate(),))


def test_pad_divisible(mesh_ranks):
    assert all(out['pad'] == (16, 16) for out in mesh_ranks)


def test_matches_single_process(mesh_ranks):
    """The 4-rank step equals SGD on the whole batch in one process."""
    w0, xs, ys = linear_problem()
    w = torch.nn.Parameter(torch.from_numpy(w0))
    loss = ((torch.from_numpy(xs) @ w - torch.from_numpy(ys)) ** 2).mean()
    loss.backward()
    want = (w - 0.1 * w.grad).detach().numpy()
    for out in mesh_ranks:
        np.testing.assert_allclose(out['w'], want, rtol=0, atol=1e-5)


def test_params_stay_replicated(mesh_ranks):
    """Every rank starts from different values, takes rank 0's, and ends
    with the same bits; floating logs averaged, integer logs summed, each
    rank's seed folded with its rank."""
    for out in mesh_ranks[1:]:
        np.testing.assert_array_equal(out['w'], mesh_ranks[0]['w'])
        assert out['logs'] == mesh_ranks[0]['logs']
    logs = mesh_ranks[0]['logs']
    assert logs['rows8'] == (torch.int64, 8 * 32)
    assert logs['loss'][0] == torch.float32
    from nerficg_torch.parallel.data_parallel import fold_seed
    assert logs['seed'][1] == sum(fold_seed(12345, r)
                                  for r in range(WORLD))


def test_gather_map_splits_items(mesh_ranks):
    """Rank r computes items r, r + 4, ...; every rank receives every
    result in order. A one-rank layout computes all of them itself."""
    want = [(i, c, i % WORLD) for i, c in enumerate('abcdefghij')]
    for rank, out in enumerate(mesh_ranks):
        assert out['gathered'] == want
        assert out['alone'] == [rank] * 3


def test_multihost_mesh(mesh_ranks):
    for rank, out in enumerate(mesh_ranks):
        assert out['mesh2d'] == ((2, 2), ('dcn', 'ici'),
                                 [rank // 2, rank % 2])
        assert out['mesh2d_default'] == (1, WORLD)


def test_2d_data_spec_shards_batch(mesh_ranks):
    x = np.arange(WORLD * 4.0).reshape(WORLD * 2, 2)
    for rank, out in enumerate(mesh_ranks):
        local, total = out['shard2d']
        np.testing.assert_array_equal(local, x[2 * rank:2 * rank + 2])
        assert total == float(x.sum())


def test_initialize_distributed_single_process_noop(monkeypatch):
    for key in ('WORLD_SIZE', 'RANK', 'MASTER_ADDR'):
        monkeypatch.delenv(key, raising=False)
    assert initialize_distributed(device_type='cpu') == 1
    assert not torch.distributed.is_initialized() and process_count() == 1


def test_backend_rule():
    assert choose_backend('cuda', 4, 4) == 'nccl'
    assert choose_backend('cuda', 1, 1) == 'nccl'
    assert choose_backend('cuda', 2, 1) == 'gloo'      # ranks share a card
    assert choose_backend('cpu', 2, 8) == 'gloo'


def test_trainer_refuses_fewer_devices_than_ranks(monkeypatch, tmp_path):
    """NUM_DEVICES below the world size would leave ranks out of the step."""
    import nerficg_torch.methods.base.trainer as base
    monkeypatch.setattr(base, 'process_count', lambda: 2)
    scene = make_textured_scene(tmp_path / 's', image_size=8, n_train=2,
                                n_test=1)
    with pytest.raises(TrainerError, match='nproc_per_node 1'):
        TMethods.get_training_instance(TConfigNode(_config(scene)),
                                       device='cpu')


def test_test_render_outlasting_the_group_timeout(tmp_path):
    """Rank 0 alone would take at least 8 s over the four test views, more
    than the group's 6 s timeout, while rank 1 waits; over both ranks no
    collective waits longer than one view. The run finishes, rank 0
    writes every view, and both ranks return the metrics that rank 0
    computes alone."""
    from torch_dist_ranks import SHORT_TIMEOUT_S, SLOW_RENDER_S
    views = 4
    scene = make_textured_scene(tmp_path / 'scene', image_size=16,
                                n_train=4, n_test=views)
    assert views * SLOW_RENDER_S > SHORT_TIMEOUT_S
    cfg = _config(scene, iterations=2)
    cfg['GLOBAL']['NUM_DEVICES'] = 2
    (tmp_path / 'config.json').write_text(json.dumps(cfg))
    ranks = launch('slow_test_render', 2, tmp_path)
    assert ranks[0]['output_dir'] == ranks[1]['output_dir']
    assert ranks[0]['metrics'] == ranks[1]['metrics'] == ranks[0]['alone']
    run = Path(ranks[0]['output_dir'])
    assert sorted(p.name for p in (run / 'test' / 'rgb').iterdir()) == \
        [f'{i:05d}.png' for i in range(views)]
    lines = [line for line in (run / 'test' / 'metrics_8bit.txt')
             .read_text().splitlines() if not line.startswith('#')]
    assert [line[:6] for line in lines] == \
        [f'{i:05d}:' for i in range(views)] + ['mean: ']


# -- one Instant-NGP / D-NeRF step against the JAX DP step ----

def _he_tree(params, seed=0, deform_out=0.05):
    """Table U(-0.1, 0.1), He-uniform MLPs (the deformation's output layer
    U(-deform_out, deform_out), so that every layer has a gradient)."""
    rng = np.random.default_rng(seed)

    def he_uniform(w):
        bound = np.sqrt(6.0 / w.shape[0])
        return rng.uniform(-bound, bound, w.shape).astype(np.float32)
    tree = {'hash_table': rng.uniform(-0.1, 0.1, params['hash_table'].shape
                                      ).astype(np.float32)}
    for name in ('density_mlp', 'color_mlp', 'deform_mlp'):
        if name in params:
            tree[name] = [he_uniform(np.asarray(w)) for w in params[name]]
    if 'deform_mlp' in tree:
        tree['deform_mlp'][-1] = rng.uniform(
            -deform_out, deform_out, tree['deform_mlp'][-1].shape).astype(
            np.float32)
    return tree


def _dnerf_config(scene):
    cfg = _config(scene)
    cfg['GLOBAL'].update({'METHOD_TYPE': 'DNeRF', 'DATASET_TYPE': 'DNeRF'})
    cfg['MODEL'] = {'NUM_LEVELS': 4, 'LOG2_HASHMAP_SIZE': 11,
                    'BASE_RESOLUTION': 4, 'TARGET_RESOLUTION': 64,
                    'GRID_RESOLUTION': 32, 'SCALE': 1.0, 'DEFORM_WIDTH': 32,
                    'DEFORM_LAYERS': 2}
    cfg['RENDERER'].pop('PROBE_MODE')
    return cfg


def _offset_points(jt, key):
    """The offset prior's points and times that the JAX trainer draws from
    ``key`` (nerficg_tpu/methods/dnerf/trainer.py)."""
    kp, kt = jax.random.split(jax.random.fold_in(key, 0x0FF5E7))
    n = int(jt.OFFSET_REG_POINTS)
    pos = jax.random.uniform(kp, (n, 3), jnp.float32,
                             minval=jt.model.aabb_min,
                             maxval=jt.model.aabb_max)
    return np.asarray(pos), np.asarray(jax.random.uniform(kt, (n,)))


def _jax_dp_step(cfg, tree, grid, ids, bg, key):
    """The JAX trainer's DP step on WORLD devices, and the mean of its
    shards' gradients (each shard's loss as the DP step's grad_fn computes
    it) with every shard's block count."""
    jt = JMethods.get_training_instance(JConfigNode(cfg))
    jt.model.params = jax.tree_util.tree_map(jnp.asarray, tree)
    jt.model.buffers['density_grid'] = jnp.asarray(grid)
    jt.opt_state = None
    jt._init_samplers(JDatasets.get_dataset(JConfigNode(cfg)))
    assert jt._num_devices() == WORLD
    jr, pool = jt.renderer, jt._pool
    n, local = ids.shape[0], ids.shape[0] // WORLD
    spr = min(max(int(jt.TARGET_BATCH_SIZE) // n, 4), int(jr.MAX_SAMPLES))
    has_time = pool.get('timestamps') is not None
    binary = jr.grid_binary()

    def shard_loss(p, shard_ids, rng):     # trainer.py:248-277
        target = pool['rgb'][shard_ids] * pool['alpha'][shard_ids] + \
            jnp.asarray(bg) * (1.0 - pool['alpha'][shard_ids])
        out = jr._render_rays_impl(
            p, binary, pool['origins'][shard_ids],
            pool['directions'][shard_ids], rng, jnp.asarray(bg),
            randomized=True, num_rays=local, samples_per_ray=spr,
            timestamps=pool['timestamps'][shard_ids] if has_time else None)
        mask = out['ray_mask']
        color = jnp.sum((out['rgb'] - target) ** 2 * mask) / \
            jnp.maximum(jnp.sum(mask) * 3.0, 1.0)
        extra, _ = jt._loss_extras(p, rng)
        loss = color + float(jt.WEIGHT_DECAY) * \
            jr.model.mlp_weight_squares(p) + extra
        return loss, out['num_blocks']

    grad_fn = jax.jit(jax.value_and_grad(shard_loss, has_aux=True))
    grads, blocks = None, []
    for r in range(WORLD):
        (_, nb), g = grad_fn(jt.model.params,
                             jnp.asarray(ids[r * local:(r + 1) * local]),
                             jax.random.fold_in(key, r))
        blocks.append(int(nb))
        grads = g if grads is None else jax.tree_util.tree_map(
            jnp.add, grads, g)
    grads = jax.tree_util.tree_map(lambda g: np.asarray(g) / WORLD, grads)
    step = jt._get_train_step(n)
    params, _, logs = step(jt.model.params, jt.opt_state, binary, pool,
                           jnp.asarray(ids, jnp.int32), key, jnp.asarray(bg))
    return jt, grads, jax.tree_util.tree_map(np.asarray, params), \
        {k: np.asarray(v) for k, v in logs.items()}, blocks


def _assert_close(got, want, what):
    for name, w_value in want.items():
        g_list = [got[name]] if name == 'hash_table' else got[name]
        w_list = [w_value] if name == 'hash_table' else w_value
        for i, (g, w) in enumerate(zip(g_list, w_list)):
            w = np.asarray(w)
            norm = np.linalg.norm(w)
            assert norm > 0.0, f'{what} {name}[{i}] is zero'
            err = np.linalg.norm(np.asarray(g) - w) / norm
            assert err <= FROBENIUS_RTOL, f'{what} {name}[{i}]: {err:.2e}'


def _run_dp_step(tmp_path, cfg, dnerf: bool):
    cfg = json.loads(json.dumps(cfg))
    cfg['GLOBAL']['NUM_DEVICES'] = WORLD
    jt = JMethods.get_training_instance(JConfigNode(cfg))
    tree = _he_tree(jax.tree_util.tree_map(np.asarray, jt.model.params),
                    seed=7)
    grid = _shell_grid(32, 2, 1.0)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 8 * 32 * 32, size=256)
    bg = rng.random(3).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jt, grads, params, logs, blocks = _jax_dp_step(cfg, tree, grid, ids, bg,
                                                   key)
    inputs = {'grid': grid, 'ids': ids, 'bg': bg, 'seeds': np.asarray(
        [int(jax.random.bits(jax.random.fold_in(key, r), dtype=jnp.uint32))
         for r in range(WORLD)], np.int64)}
    if dnerf:
        points = [_offset_points(jt, jax.random.fold_in(key, r))
                  for r in range(WORLD)]
        inputs['offset_pos'] = np.stack([p for p, _ in points])
        inputs['offset_t'] = np.stack([t for _, t in points])
    (tmp_path / 'config.json').write_text(json.dumps(cfg))
    np.savez(tmp_path / 'inputs.npz', **inputs)
    with open(tmp_path / 'tree.pkl', 'wb') as f:
        pickle.dump(tree, f)
    ranks = launch('dp_step', WORLD, tmp_path)
    return ranks, grads, params, logs, blocks


@pytest.fixture(scope='module')
def ingp_step(tmp_path_factory):
    root = tmp_path_factory.mktemp('dp_ingp')
    scene = make_textured_scene(root / 'scene', image_size=32, n_train=8,
                                n_test=2)
    return _run_dp_step(root, _config(scene), dnerf=False)


@pytest.fixture(scope='module')
def dnerf_step(tmp_path_factory):
    root = tmp_path_factory.mktemp('dp_dnerf')
    scene = make_dynamic_textured_scene(root / 'scene', image_size=32,
                                        n_train=8, n_test=2)
    return _run_dp_step(root, _dnerf_config(scene), dnerf=True)


@pytest.mark.parametrize('which', ['ingp', 'dnerf'])
def test_dp_step_matches_jax(which, request):
    ranks, grads, params, logs, _ = request.getfixturevalue(
        f'{which}_step')
    for out in ranks:
        assert out['logs']['total'] == pytest.approx(float(logs['total']),
                                                     rel=LOSS_RTOL)
        _assert_close(out['grads'], grads, 'gradient')
        _assert_close(out['params'], params, 'parameter')
    if which == 'dnerf':
        assert ranks[0]['logs']['offset_reg'] == pytest.approx(
            float(logs['offset_reg']), rel=LOSS_RTOL)


@pytest.mark.parametrize('which', ['ingp', 'dnerf'])
def test_ranks_stay_bit_equal(which, request):
    ranks = request.getfixturevalue(f'{which}_step')[0]
    for out in ranks[1:]:
        np.testing.assert_array_equal(out['final_grid'],
                                      ranks[0]['final_grid'])
        for name, value in ranks[0]['final_params'].items():
            values = [value] if name == 'hash_table' else value
            got = out['final_params'][name]
            for i, v in enumerate(values):
                np.testing.assert_array_equal(
                    got if name == 'hash_table' else got[i], v,
                    err_msg=f'{name}[{i}]')
    assert ranks[0]['final_grid'].max() > 0.0


def test_integer_logs_summed_not_device_0(ingp_step):
    """JAX's DP step returns device 0's block count; the port's the sum,
    which equals the sum of JAX's shards' counts."""
    ranks, _, _, logs, blocks = ingp_step
    assert len(set(blocks)) > 1, blocks          # the shards differ
    assert int(logs['num_blocks']) == blocks[0]  # the reference's fault
    assert ranks[0]['logs_int'] == ['num_blocks', 'num_samples']
    assert all(out['logs']['num_blocks'] == sum(blocks) for out in ranks)


# -- the trainer through torchrun against the JAX trainer ---------------------

class TwoRanks:
    """``python -m torch.distributed.run --standalone --nproc_per_node 2 -m
    nerficg_torch.scripts.train -c CFG --device cpu`` started in the
    background in ``root / 'port'``, its output in ``root / 'port.log'``."""

    def __init__(self, root: Path, cfg: dict):
        save_config(TConfigNode(cfg), root / 'port.yaml')
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS='1')
        for key in ('WORLD_SIZE', 'RANK', 'LOCAL_RANK', 'MASTER_ADDR',
                    'MASTER_PORT'):
            env.pop(key, None)
        self.dir, self.log = root / 'port', root / 'port.log'
        self.dir.mkdir()
        with open(self.log, 'w') as log:
            self.proc = subprocess.Popen(
                [sys.executable, '-m', 'torch.distributed.run',
                 '--standalone', '--nproc_per_node', '2', '-m',
                 'nerficg_torch.scripts.train', '-c', str(root / 'port.yaml'),
                 '--device', 'cpu'], cwd=self.dir, env=env, stdout=log,
                stderr=subprocess.STDOUT)

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def run_dir(self, method: str) -> Path:
        """Waits (TRAIN_TIMEOUT_S) for a clean exit; the one run directory
        (rank 0 alone writes)."""
        try:
            code = self.proc.wait(timeout=TRAIN_TIMEOUT_S)
        finally:
            self.close()
        assert code == 0, self.log.read_text()[-4000:]
        runs = list((self.dir / 'output' / method).iterdir())
        assert len(runs) == 1, runs
        for name in ('timings.txt', 'vram_stats.txt', 'training_config.yaml',
                     'test/metrics_8bit.txt', 'checkpoints/final.ckpt'):
            assert (runs[0] / name).is_file(), name
        return runs[0]


def _test_psnr(run: Path) -> float:
    return float((run / 'test' / 'metrics_8bit.txt').read_text()
                 .splitlines()[-1].split('PSNR=')[1].split()[0])


@pytest.fixture(scope='module')
def dnerf_ranks(tmp_path_factory):
    """D-NeRF over two ranks, started when first requested (by the
    Instant-NGP trainer test, so that both run beside the JAX trainer)."""
    root = tmp_path_factory.mktemp('dnerf_ranks')
    scene = make_dynamic_textured_scene(root / 'scene', image_size=32,
                                        n_train=8, n_test=2)
    cfg = _dnerf_config(scene)
    cfg['GLOBAL']['NUM_DEVICES'] = 2
    cfg['TRAINING']['NUM_ITERATIONS'] = TRAIN_ITERATIONS // 2
    ranks = TwoRanks(root, cfg)
    yield cfg, ranks
    ranks.close()


def test_trainer_two_ranks_matches_jax(tmp_path, dnerf_ranks):
    """The port's two ranks run in the background while the JAX trainer
    trains in this process."""
    scene = make_textured_scene(tmp_path / 'scene', image_size=32,
                                n_train=8, n_test=2)
    cfg = _config(scene, iterations=TRAIN_ITERATIONS)
    cfg['GLOBAL']['NUM_DEVICES'] = 2
    cfg['TRAINING']['BATCH_RESIZE_INTERVAL'] = 10 ** 6
    ranks = TwoRanks(tmp_path, cfg)
    old_base = JDirectories.base
    JDirectories.base = tmp_path / 'jax'
    try:
        jt = JMethods.get_training_instance(JConfigNode(cfg))
        assert jt._num_devices() == 2
        jt.run(JDatasets.get_dataset(JConfigNode(cfg)))
        run = ranks.run_dir('InstantNGPModel')
    finally:
        JDirectories.base = old_base
        ranks.close()
    jax_psnr = _test_psnr(jt.output_dir)
    port_psnr = _test_psnr(run)
    assert np.isfinite(port_psnr)
    assert abs(port_psnr - jax_psnr) <= PSNR_BAND_DB, (port_psnr, jax_psnr)
    jm = JMethods.get_model(JConfigNode(cfg),
                            checkpoint=str(run / 'checkpoints' / 'final.ckpt'))
    assert jm.num_iterations_trained == TRAIN_ITERATIONS


def test_dnerf_trains_over_two_ranks(dnerf_ranks):
    """D-NeRF under torchrun: one run directory, a finite test PSNR, a
    final.ckpt that loads in the JAX model."""
    cfg, ranks = dnerf_ranks
    run = ranks.run_dir('DNeRFModel')
    assert np.isfinite(_test_psnr(run))
    jm = JMethods.get_model(JConfigNode(cfg),
                            checkpoint=str(run / 'checkpoints' / 'final.ckpt'))
    assert jm.num_iterations_trained == TRAIN_ITERATIONS // 2
