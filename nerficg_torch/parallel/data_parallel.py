"""Data-parallel training steps over the ranks of a process group.

Port of nerficg_tpu/parallel/data_parallel.py, whose step runs under
``shard_map`` over a 1-D ``data`` mesh: the batch split on its leading
axis, parameters and optimizer state replicated, gradients averaged with
one ``pmean`` before the replicated optimizer update. Here each rank is a
process: it computes the gradients of its block of the batch with its own
seeds, the gradients are averaged by ONE all-reduce of a flat buffer (the
sum divided by the world size, as ``pmean`` does), and every rank steps its
optimizer on the same averaged gradients.

Every rank's all-reduce returns the same bits (gloo and NCCL alike) and
Adam is elementwise, so parameters that start equal stay bit-equal on
every rank. The all-reduce of ``.grad`` is written by hand, not
``DistributedDataParallel``: the loss is not the forward of one
``nn.Module``. Overlapping the reduce with the backward is not done.

Logs: floating ones are averaged over the ranks. Integer ones (sample and
block counts) are summed, so a caller sees the whole batch's count. The
JAX step returns device 0's value for them (``out_specs=P()`` on a value
that differs per device); the port does not copy that.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from nerficg_torch.ops.counter_rng import M32, mix32, mul32
from nerficg_torch.parallel.mesh import RenderMesh

__all__ = ['make_data_parallel_train_step', 'fold_seed', 'all_reduce_grads',
           'reduce_logs', 'replicate', 'shard_leading']

_FOLD = 0x85EBCA6B


def fold_seed(seed: int, index: int) -> int:
    """A uint32 seed for shard ``index`` of a step drawn with ``seed`` (the
    counter hash of ``ops/counter_rng.py``; the JAX step uses
    ``jax.random.fold_in(rng, axis_index)``)."""
    return int(mix32((int(seed) & M32) ^ mul32(int(index) + 1, _FOLD)))


def all_reduce_grads(params: list, world: int) -> None:
    """Replace every parameter's ``.grad`` (zeros where it has none) by its
    mean over the ranks: one all-reduce of a flat buffer (per dtype; the
    port's parameters are all float32)."""
    by_dtype: dict = {}
    for p in params:
        by_dtype.setdefault(p.dtype, []).append(p)
    for group in by_dtype.values():
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in group])
        dist.all_reduce(flat)
        flat.div_(world)
        offset = 0
        for p in group:
            n = p.numel()
            p.grad = flat[offset:offset + n].view_as(p)
            offset += n


def reduce_logs(logs: dict, world: int) -> dict:
    """Floating logs averaged over the ranks, integer logs summed: one
    all-reduce of the values in float64 (exact for counts below 2^53)."""
    if not logs:
        return logs
    device = next((v.device for v in logs.values()
                   if isinstance(v, torch.Tensor)), torch.device('cpu'))
    values = [torch.as_tensor(v, device=device) for v in logs.values()]
    packed = torch.stack([v.reshape(()).double() for v in values])
    dist.all_reduce(packed)
    out = {}
    for (key, v), total in zip(zip(logs, values), packed):
        if v.is_floating_point():
            out[key] = (total / world).to(v.dtype)
        else:
            out[key] = total.round().to(v.dtype)
    return out


def make_data_parallel_train_step(mesh: RenderMesh, grad_fn: Callable,
                                  optimizer: torch.optim.Optimizer,
                                  update: Optional[Callable] = None,
                                  fold: Callable = fold_seed) -> Callable:
    """Build a data-parallel train step.

    ``grad_fn(batch, seeds) -> logs`` runs the forward and backward of a
    tree of (n, ...) tensors, leaving the gradients in the ``.grad`` of
    ``optimizer``'s parameters. The returned ``step(batch, seeds) -> logs``
    takes the whole batch (its leading axis divides by the ranks) and a
    tuple of uint32 seeds; on each rank it calls ``grad_fn`` on the rank's
    contiguous block with every seed folded with the rank (``fold``),
    averages the gradients (``all_reduce_grads``) and the logs
    (``reduce_logs``), then applies ``update`` (default:
    ``optimizer.step``). One rank: no collective."""
    params = [p for group in optimizer.param_groups for p in group['params']]
    world = mesh.num_devices
    apply = update if update is not None else optimizer.step

    def step(batch, seeds: tuple) -> dict:
        logs = grad_fn(mesh.shard_batch(batch),
                       tuple(fold(s, mesh.rank) for s in seeds))
        if world > 1:
            all_reduce_grads(params, world)
            logs = reduce_logs(logs, world)
        apply()
        return logs

    return step


def replicate(mesh: RenderMesh, tree):
    """Every tensor of ``tree`` broadcast from rank 0, in place."""
    return mesh.replicate(tree)


def shard_leading(mesh: RenderMesh, tree):
    """This rank's contiguous block of the leading axis of every tensor."""
    return mesh.shard_batch(tree)
