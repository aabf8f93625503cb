"""Process groups, device meshes and the data-parallel layout.

Port of nerficg_tpu/parallel/mesh.py (reference: the reference's whole
multi-device story is a ``torch.nn.DataParallel`` wrap,
src/Methods/Base/Renderer.py:20-38). The JAX package runs one controller
over a ``jax.sharding.Mesh``; the port runs one process per rank of a
``torch.distributed`` group, and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over its ranks. Rays, pixels
and image tiles are split over the ``data`` axis in contiguous blocks of
the leading axis (the block ``P('data')`` gives device ``r`` in the JAX
package is rank ``r``'s); parameters are replicated.

Backend, a rule rather than a fallback: NCCL where every rank of a host has
a card of its own, gloo on the CPU and where ranks share a card (NCCL
refuses two ranks on one device). Every collective of the group carries
its timeout, so a rank left waiting fails instead of hanging.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, Iterator, Optional, Sequence

import torch
import torch.distributed as dist

from nerficg_torch.core.errors import ShardingError
from nerficg_torch.core.logging import Logger

__all__ = ['RenderMesh', 'make_mesh', 'make_multihost_mesh',
           'initialize_distributed', 'shard_rays_spec', 'replicated_spec',
           'shard_rays_spec_2d', 'choose_backend', 'process_index',
           'process_count', 'DATA_AXIS', 'ICI_AXIS', 'DCN_AXIS']

DATA_AXIS = 'data'
ICI_AXIS = 'ici'
DCN_AXIS = 'dcn'

# Seconds a collective (and the group's start) waits for every rank.
COLLECTIVE_TIMEOUT_S = 600.0


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The group's world size (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def choose_backend(device_type: str, local_world_size: int,
                   device_count: int) -> str:
    """'nccl' where every rank of a host has a card of its own, else
    'gloo' (the CPU, or ranks sharing a card)."""
    if device_type == 'cuda' and local_world_size <= device_count:
        return 'nccl'
    return 'gloo'


def _init_method(coordinator_address: Optional[str]) -> str:
    if coordinator_address is None:
        return 'env://'
    if '://' in coordinator_address:
        return coordinator_address
    return f'tcp://{coordinator_address}'


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device_type: str = 'cuda',
                           timeout_s: float = COLLECTIVE_TIMEOUT_S) -> int:
    """Join the process group; returns its world size.

    ``coordinator_address`` is ``host:port`` (or a ``tcp://``/``file://``
    init method), ``num_processes`` the world size and ``process_id`` this
    rank, as ``jax.distributed.initialize`` takes them. Each that is not
    given comes from torchrun's environment (``MASTER_ADDR``/
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). A no-op that returns 1 in
    one process (no world size above 1 given or in the environment), and
    the world size when the group is already up. ``device_type`` is where
    the ranks compute: it picks the backend (``choose_backend``, with
    torchrun's ``LOCAL_WORLD_SIZE`` ranks on this host), logged once."""
    if dist.is_initialized():
        return dist.get_world_size()
    world = int(num_processes if num_processes is not None
                else os.environ.get('WORLD_SIZE', 1))
    if world <= 1:
        return 1
    rank = int(process_id if process_id is not None
               else os.environ.get('RANK', -1))
    if not 0 <= rank < world:
        raise ShardingError(f'rank {rank} is not in [0, {world}): give '
                            f'process_id or launch with torchrun')
    if coordinator_address is None and 'MASTER_ADDR' not in os.environ:
        raise ShardingError('no coordinator: give coordinator_address or '
                            'launch with torchrun (MASTER_ADDR/MASTER_PORT)')
    local_world = int(os.environ.get('LOCAL_WORLD_SIZE', world))
    count = torch.cuda.device_count() if device_type == 'cuda' else 0
    backend = choose_backend(device_type, local_world, count)
    if backend == 'nccl':
        torch.cuda.set_device(int(os.environ.get('LOCAL_RANK', rank)) % count)
    dist.init_process_group(
        backend, init_method=_init_method(coordinator_address),
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    if rank == 0:
        Logger.info(f'distributed: {world} ranks over {backend} '
                    f'({local_world} on this host, {count} card(s) '
                    f'visible), collectives time out after {timeout_s:g} s')
    return world


def make_mesh(num_devices: Optional[int] = None):
    """1-D ``DeviceMesh`` over the first ``num_devices`` ranks (default:
    all) on the ``data`` axis. Needs the group (initialize_distributed)."""
    from torch.distributed.device_mesh import DeviceMesh
    world = _group_size()
    n = world if num_devices is None else int(num_devices)
    if not 1 <= n <= world:
        raise ShardingError(f'requested {n} devices, only {world} ranks')
    return DeviceMesh(_mesh_device_type(), list(range(n)),
                      mesh_dim_names=(DATA_AXIS,))


def make_multihost_mesh(ici_axis_size: Optional[int] = None):
    """2-D (dcn, ici) ``DeviceMesh``: ``dcn`` indexes groups of
    ``ici_axis_size`` consecutive ranks (default: a host's ranks, torchrun's
    ``LOCAL_WORLD_SIZE``), so collectives along ``ici`` stay on a host and
    only ``dcn`` crosses hosts. Data parallelism splits batches over both
    axes, flattened (``shard_rays_spec_2d``)."""
    from torch.distributed.device_mesh import DeviceMesh
    world = _group_size()
    per_host = int(os.environ.get('LOCAL_WORLD_SIZE', world))
    ici = per_host if ici_axis_size is None else int(ici_axis_size)
    if ici < 1 or per_host % ici != 0 or world % ici != 0:
        raise ShardingError(f'ici axis {ici} must divide the {per_host} '
                            f'ranks of a host')
    grid = torch.arange(world).reshape(world // ici, ici)
    return DeviceMesh(_mesh_device_type(), grid,
                      mesh_dim_names=(DCN_AXIS, ICI_AXIS))


def _group_size() -> int:
    if not dist.is_initialized():
        raise ShardingError('a DeviceMesh needs the process group: call '
                            'initialize_distributed (or launch with '
                            'torchrun) first')
    return dist.get_world_size()


def _mesh_device_type() -> str:
    """Where the group's collectives run: NCCL's on the cards, gloo's on
    the host (its CUDA tensors are staged through it)."""
    return 'cuda' if dist.get_backend() == 'nccl' else 'cpu'


def shard_rays_spec() -> tuple:
    """The leading (ray/pixel/tile) axis split over the data axis."""
    from torch.distributed.tensor import Shard
    return (Shard(0),)


def replicated_spec() -> tuple:
    from torch.distributed.tensor import Replicate
    return (Replicate(),)


def shard_rays_spec_2d() -> tuple:
    """The leading axis split over both axes of a (dcn, ici) mesh, dcn
    major: rank d * ici + i holds block d * ici + i."""
    from torch.distributed.tensor import Shard
    return (Shard(0), Shard(0))


class RenderMesh:
    """The data-parallel layout of a training or render session: its
    number of ranks, this process's rank, and the placements of a batch.

    Replaces ``BaseRenderingComponent.get``'s DataParallel wrap (reference:
    Renderer.py:20-38): a trainer splits each ray batch over the ranks
    (``shard_batch``), a renderer the views of a test set (``gather_map``).
    In one process it is a one-rank layout that needs no group."""

    def __init__(self, num_devices: Optional[int] = None):
        world = process_count()
        self._num = world if num_devices is None else int(num_devices)
        if not 1 <= self._num <= world:
            raise ShardingError(f'requested {self._num} devices, only '
                                f'{world} ranks')
        self.rank = process_index()

    @property
    def num_devices(self) -> int:
        return self._num

    def data_sharding(self) -> tuple:
        """Placements splitting the leading axis over the data axis."""
        return shard_rays_spec()

    def replicated(self) -> tuple:
        return replicated_spec()

    def pad_divisible(self, n: int) -> int:
        """Round a batch size up so it divides evenly over the ranks."""
        d = self.num_devices
        return ((n + d - 1) // d) * d

    def shard_batch(self, tree):
        """This rank's contiguous block of the leading axis of every tensor
        (or array) in a dict/list/tuple tree; the axis must divide by the
        number of ranks."""
        def block(a):
            n = a.shape[0]
            if n % self._num != 0:
                raise ShardingError(f'leading axis {n} does not divide over '
                                    f'{self._num} ranks')
            size = n // self._num
            return a[self.rank * size:(self.rank + 1) * size]
        return _tree_map(block, tree)

    def replicate(self, tree):
        """Every tensor of a tree broadcast in place from rank 0, so that
        all ranks hold rank 0's values (a no-op in one process)."""
        if self._num > 1:
            for t in _tree_leaves(tree):
                dist.broadcast(t, src=0)
        return tree

    def gather_map(self, fn: Callable, items: Sequence) -> Iterator:
        """Yield ``fn(i, item)`` for every item, in order, on every rank.

        Over n > 1 ranks the items go round in rounds of n: rank r
        computes item ``start + r`` of each round, then one
        ``all_gather_object`` hands the round's results to every rank, so
        no rank waits in a collective for longer than one item's work.
        Every rank of the group must consume the whole generator. With one
        rank in the layout, a plain loop in this process."""
        items = list(items)
        if self._num == 1:
            for i, item in enumerate(items):
                yield fn(i, item)
            return
        for start in range(0, len(items), self._num):
            i = start + self.rank
            mine = fn(i, items[i]) \
                if self.rank < self._num and i < len(items) else None
            gathered = [None] * process_count()
            dist.all_gather_object(gathered, mine)
            yield from gathered[:min(self._num, len(items) - start)]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [] if tree is None else [tree]
