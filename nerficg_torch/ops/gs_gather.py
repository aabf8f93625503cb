"""The rasterizer's entry gather: the (tile, depth)-sorted 16-wide stream
written straight from the Gaussians, and its gradient.

``gs_rasterize.entry_stream`` duplicates each of N Gaussians into D
entries (entry d N + n is copy d of Gaussian n) and sorts them by (tile,
depth); ``perm`` (E,) int64, E = D N, is that sort's permutation and
``sorted_tile`` (E,) int32 the tile of each sorted column (T for none),
whose segments start at ``starts`` (T,) int32. The stream is

  sorted_mat (16, E_pad) f32: column e < E holds Gaussian perm[e] mod N's
      [mx, my, ca, cb, cc, op, r, g, b, d] in rows 0-9; rows 10-15 and the
      columns from E on are zero,

the same bits as stacking the ten attribute rows, expanding them D times,
gathering by ``perm`` and padding (the JAX package's composition,
nerficg_tpu/ops/gs_rasterize.py :314-330).

Its backward reads the stream's gradient through inv (E,) int32, the
inverse permutation over the live entries: inv[perm[e]] = e where column
e is live, in a tile and within the first k of its segment (e - starts[t]
< k), and -1 elsewhere. It sums each Gaussian's live copies in order d =
0..D-1 and skips the rest. That is exact for the gradient the compositor's
backward gives (``gs_tiles_kernel.gs_composite_bwd``, #16, and its plain
version write zero at every entry that is not live), and is the contract
of this backward: a stream gradient from anywhere else must be zero there
too.

On CUDA tensors the kernel pair of ``nerficg_torch/csrc/gs_gather.cu``
(``gs_stream_gather``, ``gs_stream_gather_bwd``); on CPU tensors the plain
versions, the same algorithm in PyTorch operations. ``stream_gather`` is
the differentiable entry; it builds inv only when autograd will need it.
"""

from __future__ import annotations

from typing import Optional

import torch

from nerficg_torch.core.errors import KernelError
from nerficg_torch.ops import _kernels

__all__ = ['stream_gather', 'gs_stream_gather', 'gs_stream_gather_bwd',
           'gs_stream_gather_plain', 'gs_stream_gather_bwd_plain']

STREAM_ROWS = 16
_ATTRS = 10
_MAX_ENTRIES = 2 ** 31      # entries index an int32


def _check_entries(name: str, entries: int) -> None:
    if entries >= _MAX_ENTRIES:
        raise KernelError(f'{name}: {entries} entries (D x N) do not fit an '
                          f'int32 index (at most 2^31 - 1)')


def _columns(means2d, conics, opacities, colors, depths) -> list:
    """The ten attribute columns in the stream's row order."""
    return [means2d[:, 0], means2d[:, 1], conics[:, 0], conics[:, 1],
            conics[:, 2], opacities, colors[:, 0], colors[:, 1],
            colors[:, 2], depths]


def gs_stream_gather_plain(means2d: torch.Tensor, conics: torch.Tensor,
                           opacities: torch.Tensor, colors: torch.Tensor,
                           depths: torch.Tensor, perm: torch.Tensor,
                           e_pad: int,
                           sorted_tile: Optional[torch.Tensor] = None,
                           starts: Optional[torch.Tensor] = None,
                           k: int = 0
                           ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(sorted_mat (16, E_pad), inv (E,) int32 or None) in PyTorch; inv
    only where ``sorted_tile`` is given."""
    n, e = means2d.shape[0], perm.shape[0]
    src = torch.remainder(perm, max(n, 1))
    mat = means2d.new_zeros((STREAM_ROWS, e_pad))
    for row, col in enumerate(_columns(means2d, conics, opacities, colors,
                                       depths)):
        mat[row, :e] = col[src]
    if sorted_tile is None:
        return mat, None
    cols = torch.arange(e, device=perm.device)
    tile = sorted_tile.long()
    first = torch.cat([starts.long(), starts.new_zeros(1, dtype=torch.long)])
    live = (tile < starts.shape[0]) & (cols - first[tile] < k)
    inv = torch.full((e,), -1, dtype=torch.int32, device=perm.device)
    inv[perm[live]] = cols[live].to(torch.int32)
    return mat, inv


def gs_stream_gather(means2d: torch.Tensor, conics: torch.Tensor,
                     opacities: torch.Tensor, colors: torch.Tensor,
                     depths: torch.Tensor, perm: torch.Tensor, e_pad: int,
                     sorted_tile: Optional[torch.Tensor] = None,
                     starts: Optional[torch.Tensor] = None, k: int = 0
                     ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The forward kernel: (sorted_mat (16, E_pad), inv or None), not
    differentiable; inv only where ``sorted_tile`` (with ``starts`` and
    ``k``) is given. CUDA tensors launch the kernel, CPU tensors take the
    plain version."""
    name = 'gs_stream_gather'
    n, e = means2d.shape[0], perm.shape[0]
    _check_entries(name, e)
    if e % max(n, 1) or e_pad < e:
        raise KernelError(f'{name}: {e} entries are no multiple of {n} '
                          f'Gaussians, or E_pad {e_pad} is below them')
    if means2d.device.type == 'cpu':
        return gs_stream_gather_plain(means2d, conics, opacities, colors,
                                      depths, perm, e_pad, sorted_tile,
                                      starts, k)
    _kernels.require_cuda(name, means2d, conics, opacities, colors, depths,
                          perm, dtypes=(torch.float32,) * 5 + (torch.int64,))
    for t, shape in ((means2d, (n, 2)), (conics, (n, 3)), (opacities, (n,)),
                     (colors, (n, 3)), (depths, (n,))):
        if tuple(t.shape) != shape:
            raise KernelError(f'{name}: an attribute must be {shape}, got '
                              f'{tuple(t.shape)}')
    dev = means2d.device
    mat = torch.empty((STREAM_ROWS, e_pad), dtype=torch.float32, device=dev)
    inv, num_tiles = None, 0
    if sorted_tile is not None:
        _kernels.require_cuda(name, means2d, sorted_tile, starts,
                              dtypes=(torch.float32, torch.int32,
                                      torch.int32))
        if sorted_tile.shape != (e,) or starts.ndim != 1:
            raise KernelError(f'{name}: sorted_tile must be ({e},) and '
                              f'starts (T,)')
        inv = torch.empty(e, dtype=torch.int32, device=dev)
        num_tiles = starts.shape[0]
    code = _kernels.load_library().nerficg_gs_stream_gather(
        means2d.data_ptr(), conics.data_ptr(), opacities.data_ptr(),
        colors.data_ptr(), depths.data_ptr(), perm.data_ptr(),
        _kernels.ptr(sorted_tile), _kernels.ptr(starts), mat.data_ptr(),
        _kernels.ptr(inv), n, num_tiles, k, e, e_pad,
        _kernels.stream_of(means2d))
    _kernels.check(code, name)
    gs_stream_gather.launches += 1
    return mat, inv


def gs_stream_gather_bwd_plain(d_sorted: torch.Tensor, inv: torch.Tensor,
                               n: int) -> tuple[torch.Tensor, ...]:
    """The backward in PyTorch: the kernel's skips, its sums over d in
    order; (d means2d (N, 2), d conics (N, 3), d opacities (N,), d colors
    (N, 3), d depths (N,))."""
    e = inv.reshape(inv.shape[0] // max(n, 1), n).long()        # (D, N)
    grads = torch.where(e >= 0, d_sorted[:_ATTRS, e.clamp(min=0)], 0.0)
    total = d_sorted.new_zeros((_ATTRS, n))
    for d in range(e.shape[0]):
        total = total + grads[:, d]
    return (total[0:2].T.contiguous(), total[2:5].T.contiguous(),
            total[5].contiguous(), total[6:9].T.contiguous(),
            total[9].contiguous())


def gs_stream_gather_bwd(d_sorted: torch.Tensor, inv: torch.Tensor,
                         n: int) -> tuple[torch.Tensor, ...]:
    """The backward kernel: the five attributes' gradients of N Gaussians
    from the stream's, ``d_sorted`` (16, E_pad), zero where not live (#16's
    contract), and the forward's ``inv``. CUDA tensors launch the kernel,
    CPU tensors take the plain version."""
    name = 'gs_stream_gather_bwd'
    e = inv.shape[0]
    _check_entries(name, e)
    if inv.ndim != 1 or e % max(n, 1):
        raise KernelError(f'{name}: inv must be (D x {n},), got '
                          f'{tuple(inv.shape)}')
    if d_sorted.device.type == 'cpu':
        return gs_stream_gather_bwd_plain(d_sorted, inv, n)
    _kernels.require_cuda(name, d_sorted, inv,
                          dtypes=(torch.float32, torch.int32))
    if d_sorted.ndim != 2 or d_sorted.shape[0] != STREAM_ROWS or \
            d_sorted.shape[1] < e:
        raise KernelError(f'{name}: d_sorted must be ({STREAM_ROWS}, '
                          f'E_pad >= {e})')
    dev = d_sorted.device
    grads = tuple(torch.empty(shape, dtype=torch.float32, device=dev)
                  for shape in ((n, 2), (n, 3), (n,), (n, 3), (n,)))
    code = _kernels.load_library().nerficg_gs_stream_gather_bwd(
        d_sorted.data_ptr(), inv.data_ptr(), *(g.data_ptr() for g in grads),
        n, e // max(n, 1), d_sorted.shape[1], _kernels.stream_of(d_sorted))
    _kernels.check(code, name)
    gs_stream_gather_bwd.launches += 1
    return grads


gs_stream_gather.launches = 0
gs_stream_gather_bwd.launches = 0


class _StreamGather(torch.autograd.Function):
    """``stream_gather`` where autograd needs it: the forward kernel with
    inv, which is all the backward kernel keeps."""

    @staticmethod
    def forward(ctx, means2d, conics, opacities, colors, depths, perm,
                sorted_tile, starts, k, e_pad):
        mat, inv = gs_stream_gather(means2d, conics, opacities, colors,
                                    depths, perm, e_pad, sorted_tile, starts,
                                    k)
        ctx.save_for_backward(inv)
        ctx.n = means2d.shape[0]
        return mat

    @staticmethod
    def backward(ctx, d_sorted):
        (inv,) = ctx.saved_tensors
        grads = gs_stream_gather_bwd(d_sorted.contiguous(), inv, ctx.n)
        return (*grads, None, None, None, None, None)


def stream_gather(means2d: torch.Tensor, conics: torch.Tensor,
                  opacities: torch.Tensor, colors: torch.Tensor,
                  depths: torch.Tensor, perm: torch.Tensor,
                  sorted_tile: torch.Tensor, starts: torch.Tensor, k: int,
                  e_pad: int) -> torch.Tensor:
    """The 16-wide stream (16, E_pad), differentiable in the five
    attributes (under the backward's contract); ``sorted_tile`` (E,) and
    ``starts`` (T,) int32 as ``entry_stream`` computes them."""
    attrs = [t.contiguous() for t in (means2d, conics, opacities, colors,
                                      depths)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in attrs):
        return _StreamGather.apply(*attrs, perm.contiguous(),
                                   sorted_tile.contiguous(),
                                   starts.contiguous(), k, e_pad)
    mat, _ = gs_stream_gather(*attrs, perm.contiguous(), e_pad)
    return mat
