"""Rank processes for tests/test_torch_parallel.py.

``launch(name, world, workdir)`` starts ``world`` processes with the spawn
start method; each joins a gloo group through ``file://workdir/rendezvous``
(no TCP port, so test workers running at once cannot collide), runs the
function ``name`` of this module as ``fn(rank, world, workdir)`` and
pickles what it returns to ``workdir/rank<r>.pkl``. A rank that fails
writes its traceback beside it; ``launch`` raises with it, and kills every
rank still running at its deadline, so that a collective that never
completes fails its test instead of hanging the suite.

This module imports torch and the port, never jax: the ranks must not
start JAX, which the test process has already started on the CPU.
"""

from __future__ import annotations

import copy
import json
import multiprocessing
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import torch

RANK_TIMEOUT_S = 120.0
GROUP_TIMEOUT_S = 60.0


def launch(name: str, world: int, workdir, timeout: float = RANK_TIMEOUT_S
           ) -> list:
    """Run ``name`` on ``world`` ranks; returns their results by rank."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context('spawn')
    procs = [ctx.Process(target=_entry, args=(name, rank, world, str(workdir)))
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10.0)
    errors = [(workdir / f'rank{r}.err').read_text()
              for r in range(world) if (workdir / f'rank{r}.err').is_file()]
    if errors:
        raise RuntimeError(f'{name}: a rank failed:\n' + '\n'.join(errors))
    if hung:
        raise TimeoutError(f'{name}: ranks {hung} still ran after {timeout} s')
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f'{name}: ranks exited with {bad}')
    results = []
    for r in range(world):
        with open(workdir / f'rank{r}.pkl', 'rb') as f:
            results.append(pickle.load(f))
    return results


def _entry(name: str, rank: int, world: int, workdir: str) -> None:
    import torch.distributed as dist

    from nerficg_torch.core.logging import Logger
    from nerficg_torch.parallel.mesh import initialize_distributed
    torch.set_num_threads(1)
    Logger.set_level('SILENT')
    path = Path(workdir)
    try:
        initialize_distributed(f'file://{path / "rendezvous"}', world, rank,
                               device_type='cpu', timeout_s=GROUP_TIMEOUT_S)
        result = globals()[name](rank, world, path)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        (path / f'rank{rank}.err').write_text(
            f'rank {rank}:\n{traceback.format_exc()}')
        raise
    with open(path / f'rank{rank}.pkl', 'wb') as f:
        pickle.dump(result, f)


# -- rank functions ----------------------------------------------------------

def linear_problem(seed: int = 0):
    """The JAX test's linear model: w (4, 2), x (32, 4), y (32, 2)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(4, 2)).astype(np.float32),
            rng.normal(size=(32, 4)).astype(np.float32),
            rng.normal(size=(32, 2)).astype(np.float32))


def linear_grad_fn(w: torch.nn.Parameter):
    """grad_fn(batch, seeds) of the mean squared error of x @ w; logs the
    loss (float) and the rank's row count times 8 (int), and the seeds."""
    def grad_fn(batch, seeds):
        w.grad = None
        loss = ((batch['x'] @ w - batch['y']) ** 2).mean()
        loss.backward()
        return {'loss': loss.detach(),
                'rows8': torch.tensor(8 * batch['x'].shape[0]),
                'seed': torch.tensor(seeds[0], dtype=torch.int64)}
    return grad_fn


def mesh_checks(rank: int, world: int, workdir: Path) -> dict:
    """The meshes, the layout and the linear data-parallel step."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from nerficg_torch.parallel.data_parallel import (
        make_data_parallel_train_step, replicate, shard_leading)
    from nerficg_torch.parallel.mesh import (RenderMesh, make_mesh,
                                             make_multihost_mesh,
                                             shard_rays_spec_2d)
    out = {}
    mesh = make_mesh()
    out['mesh'] = (mesh.size(), mesh.mesh_dim_names,
                   list(mesh.get_coordinate()))
    rm = RenderMesh()
    out['num_devices'] = rm.num_devices
    out['pad'] = (rm.pad_divisible(13), rm.pad_divisible(16))
    out['block'] = rm.shard_batch(
        {'x': torch.arange(64.0).reshape(16, 4)})['x'].numpy()
    out['placements'] = (rm.data_sharding(), rm.replicated())

    grid = make_multihost_mesh(2)
    out['mesh2d'] = (tuple(grid.shape), grid.mesh_dim_names,
                     list(grid.get_coordinate()))
    x = torch.arange(world * 4.0).reshape(world * 2, 2)
    local = distribute_tensor(x, grid, list(shard_rays_spec_2d())).to_local()
    total = local.sum()
    dist.all_reduce(total)
    out['shard2d'] = (local.numpy(), float(total))
    out['mesh2d_default'] = tuple(make_multihost_mesh().shape)

    w0, xs, ys = linear_problem()
    w = torch.nn.Parameter(torch.from_numpy(w0 + rank))   # differ per rank
    replicate(rm, [w.data])                               # rank 0's values
    optimizer = torch.optim.SGD([w], lr=0.1)
    step = make_data_parallel_train_step(rm, linear_grad_fn(w), optimizer)
    batch = {'x': torch.from_numpy(xs), 'y': torch.from_numpy(ys)}
    assert shard_leading(rm, batch)['x'].shape == (32 // world, 4)
    logs = step(batch, (12345,))
    out['w'] = w.detach().numpy().copy()
    out['logs'] = {k: (v.dtype, v.item()) for k, v in logs.items()}
    out['gathered'] = list(rm.gather_map(lambda i, item: (i, item, rank),
                                         'abcdefghij'))
    out['alone'] = list(RenderMesh(1).gather_map(lambda i, item: rank,
                                                 'abc'))
    return out


# Seconds each test view's render sleeps, and the group's collective
# timeout during the run: shorter than rank 0 alone would take over the
# test set (four views), longer than one round of views over the ranks.
SLOW_RENDER_S = 2.0
SHORT_TIMEOUT_S = 6.0


def slow_test_render(rank: int, world: int, workdir: Path) -> dict:
    """The Instant-NGP trainer of the test's config (two iterations) with
    each test view's render SLOW_RENDER_S slower, its group's collectives
    timing out after SHORT_TIMEOUT_S; then, on rank 0, the same test set
    rendered in this process alone (a one-rank layout, no collective)."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _set_pg_timeout

    from nerficg_torch.core.config import ConfigNode
    from nerficg_torch.core.registry import Datasets, Methods
    from nerficg_torch.core.setup import Directories
    from nerficg_torch.parallel.mesh import RenderMesh
    cfg = ConfigNode(json.loads((workdir / 'config.json').read_text()))
    Directories.base = workdir / 'output'
    trainer = Methods.get_training_instance(cfg, device='cpu')
    dataset = Datasets.get_dataset(cfg)
    renderer = trainer.renderer
    render = renderer.render_image

    def slow(view, benchmark=False):
        time.sleep(SLOW_RENDER_S)
        return render(view, benchmark)

    renderer.render_image = slow
    dist.barrier()
    _set_pg_timeout(datetime.timedelta(seconds=SHORT_TIMEOUT_S))
    trainer.run(dataset)
    _set_pg_timeout(datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    out = {'metrics': trainer.test_metrics,
           'output_dir': str(trainer.output_dir)}
    if rank == 0:
        renderer.render_image = render
        renderer.mesh = RenderMesh(1)
        out['alone'] = renderer.render_subset(dataset, 'test')
    return out


def _port_trainer(world: int, workdir: Path):
    """The port's trainer of the config the test wrote, with its weights
    and grid, ray pool built; and the test's inputs."""
    from nerficg_torch.core.config import ConfigNode
    from nerficg_torch.core.registry import Datasets, Methods
    cfg = json.loads((workdir / 'config.json').read_text())
    inputs = dict(np.load(workdir / 'inputs.npz'))
    with open(workdir / 'tree.pkl', 'rb') as f:
        tree = pickle.load(f)
    trainer = Methods.get_training_instance(ConfigNode(cfg), device='cpu')
    assert trainer.num_devices == world
    trainer.model.load_params_tree(tree)
    trainer.model.buffers['density_grid'] = torch.from_numpy(inputs['grid'])
    trainer._init_samplers(Datasets.get_dataset(ConfigNode(cfg)))
    return trainer, inputs


def _grads_and_params(trainer) -> tuple:
    """Copies of the gradients and parameters (``params_tree`` shares the
    parameters' memory, which later steps update in place)."""
    from nerficg_torch.methods.instant_ngp.convert import params_to_numpy
    module = trainer.model.module
    grads = params_to_numpy({k: p.grad for k, p in module.named_parameters()})
    return copy.deepcopy(grads), copy.deepcopy(trainer.model.params_tree())


def dp_step(rank: int, world: int, workdir: Path) -> dict:
    """One data-parallel step of the test's ids, background and per-rank
    march seeds (and offset-prior points, for D-NeRF), then three more
    steps with a grid refresh: the step's loss, logs, averaged gradients
    and updated parameters, and the final parameters and grid."""
    trainer, inputs = _port_trainer(world, workdir)
    seeds = [int(s) for s in inputs['seeds']]
    trainer._fold_seed = lambda seed, r: seeds[r]
    if 'offset_pos' in inputs:
        pos = torch.from_numpy(inputs['offset_pos'][rank])
        times = torch.from_numpy(inputs['offset_t'][rank])
        trainer._draw_offset_points = lambda n: (pos, times)
    logs = trainer.train_step(torch.from_numpy(inputs['ids']),
                              torch.from_numpy(inputs['bg']), 0, 0)
    grads, params = _grads_and_params(trainer)
    out = {'logs': {k: v.item() for k, v in logs.items()},
           'logs_int': sorted(k for k, v in logs.items()
                              if not v.is_floating_point()),
           'grads': grads, 'params': params}
    for it in range(1, 4):
        trainer.training_iteration(None, it)
    trainer._update_occupancy(None, 0)
    trainer.training_iteration(None, 4)
    out['final_params'] = copy.deepcopy(trainer.model.params_tree())
    out['final_grid'] = trainer.model.buffers['density_grid'].numpy().copy()
    return out
