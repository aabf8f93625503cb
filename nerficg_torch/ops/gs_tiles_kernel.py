"""Per-tile 3DGS compositing over the (tile, depth)-sorted entry stream.

Port of the stream path of nerficg_tpu/ops/gs_tiles_kernel.py
(``composite_sorted`` :739): front-to-back alpha blending of each 16x16 tile
straight from the sorted, channel-major entry stream, and its backward.

  sorted_mat (16, E_pad) f32: rows [mx, my, ca, cb, cc, op, r, g, b, d, 0..]
      over the sorted entries (training), or (8, E_pad) packed words
      [mx|my u16.u16 tile-relative, ca|cb, cc|op, r|g, b|d bf16 pairs, 0..]
      (serving); E_pad leaves >= 3k guard entries after the last one.
  starts, counts (T,) int32: each tile's segment in the stream.
  -> (T, 5, P) f32 rows [r, g, b, acc, depth]; a tile composites the first
     min(count, k) entries of its segment. (The JAX package returns
     (T, 8, P) with three zero rows, the TPU's sublane padding; the port
     leaves them out.)

Three CUDA kernels (``nerficg_torch/csrc/gs_tiles.cu``) replace the TPU's
``_fused_fwd_kernel`` (#15, :414) and ``_fused_bwd_stream_kernel`` (#16,
:481): ``gs_composite_fwd`` (16-wide; also saves each pixel's transmittance
at the start of every chunk of ``CH`` entries the tile composites, ``tacc``
(T, ceil(k/CH), P); see ``live_chunks``),
``gs_composite_fwd_packed`` (8-wide) and ``gs_composite_bwd`` (d sorted
(16, E_pad) from d out, walking each tile's chunks in reverse from the saved
transmittance). CPU tensors take the plain versions: ``_cs_plain`` (from
``_cs_jnp`` :778 and ``_composite_jnp`` :322) and its backward by autograd.

Packed means: the stream carries them tile-relative; both the kernel and
the plain version add the tile origin and composite in absolute pixels, as
the oracle does (:787-793). The TPU kernel composites against tile-local
pixels instead (:424-427); the two give the same bits, because every
quantity involved is a multiple of 1/32 px below 4096 px, exact in f32.

The packed layout is not differentiable (nerficg_tpu :816-819).

``composite_tiles`` (nerficg_tpu :361) composites per-tile slot windows
instead of the stream: slots (T, K, 10) f32, counts (T,) int32, origins
(T, 2) f32 -> (T, 8, P) with rows [r, g, b, acc, depth, 0, 0, 0],
differentiable in the slots. On CUDA tensors ``gs_tiles_fwd`` and
``gs_tiles_bwd`` launch the kernels of the same file that replace the TPU's
``_fwd_kernel`` (#13, :164) and ``_bwd_kernel`` (#14, :200); CPU tensors take
``_composite_plain`` and autograd through it, as the JAX package's CPU path
does (:398-399). Nothing in the JAX methods calls it: it is part of the op
API.
"""

from __future__ import annotations

import torch

from nerficg_torch.core.errors import KernelError
from nerficg_torch.ops import _kernels

__all__ = ['composite_sorted', 'gs_composite_fwd', 'gs_composite_fwd_packed',
           'gs_composite_bwd', 'gs_composite_fwd_plain',
           'gs_composite_bwd_plain', 'composite_tiles', 'gs_tiles_fwd',
           'gs_tiles_bwd', 'gs_tiles_fwd_plain', 'gs_tiles_bwd_plain',
           'live_chunks', 'TILE', 'P', 'CH', 'OUT_ROWS', 'SLOT_OUT_ROWS',
           'ALPHA_MIN', 'ALPHA_MAX', 'MEANS_FP_SCALE', 'MEANS_FP_BIAS']

TILE = 16
P = TILE * TILE             # pixels per tile: one CUDA thread each
CH = 32                     # entries per chunk (the port's own; see tacc)
OUT_ROWS = 5                # r, g, b, acc, depth
SLOT_OUT_ROWS = 8           # composite_tiles: the same and three zero rows
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
# Packed means (nerficg_tpu/ops/gs_rasterize.py:130-131): u16 fixed point in
# 1/32-px steps over a +-1024 px window around the entry's tile origin.
MEANS_FP_SCALE = 32.0
MEANS_FP_BIAS = 1024.0

# Tiles per step of the plain versions: bounds their (tiles, k, P)
# intermediates (256 tiles x 256 x 256 f32 = 64 MiB each).
_PLAIN_TILES = 256


def num_chunks(k: int) -> int:
    """Rows of the saved transmittance per tile."""
    return -(-k // CH)


def live_chunks(counts: torch.Tensor, k: int) -> torch.Tensor:
    """(T, ceil(k/CH)) bool: the chunks of ``tacc`` a tile composites,
    c < ceil(min(count, k) / CH). Only these hold a defined value after the
    kernel (the backward reads no other); the plain version fills the rest
    with the final transmittance."""
    n = torch.clamp(counts.long(), 0, k)
    c = torch.arange(num_chunks(k), device=counts.device)
    return c[None, :] < (-(-n // CH))[:, None]


def _as_f32(bits: torch.Tensor) -> torch.Tensor:
    """int64 holding a u32 bit pattern -> f32 with those bits."""
    signed = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return signed.to(torch.int32).view(torch.float32)


def _unpack_stream(mat8: torch.Tensor) -> torch.Tensor:
    """(E, 8) packed entry-major stream -> (E, 10) f32 with TILE-RELATIVE
    means (``_unpack_stream_jnp`` :755)."""
    words = mat8.contiguous().view(torch.int32).long() & 0xFFFFFFFF

    def unpack(col):
        v = words[:, col]
        return _as_f32(v & 0xFFFF0000), _as_f32((v << 16) & 0xFFFFFFFF)

    mword = words[:, 0]
    mx = (mword >> 16).float() / MEANS_FP_SCALE - MEANS_FP_BIAS
    my = (mword & 0xFFFF).float() / MEANS_FP_SCALE - MEANS_FP_BIAS
    ca, cb = unpack(1)
    cc, op = unpack(2)
    r, g = unpack(3)
    b, d = unpack(4)
    return torch.stack([mx, my, ca, cb, cc, op, r, g, b, d], dim=1)


def _tile_origins(num_tiles: int, tiles_x: int,
                  device: torch.device) -> torch.Tensor:
    """(T, 2) f32 pixel origins of the row-major tiles."""
    idx = torch.arange(num_tiles, dtype=torch.float32, device=device)
    return torch.stack([torch.remainder(idx, tiles_x) * TILE,
                        torch.div(idx, tiles_x, rounding_mode='floor') * TILE],
                       -1)


def _alpha_plain(slots: torch.Tensor, counts: torch.Tensor,
                 origins: torch.Tensor) -> torch.Tensor:
    """(T, K, P) alpha of every (slot, pixel) of the tiles, zero past each
    tile's count; the oracle's geometry (:335-344), op for op."""
    k = slots.shape[1]
    device = slots.device
    pix = torch.arange(TILE, dtype=torch.float32, device=device) + 0.5
    gy, gx = torch.meshgrid(pix, pix, indexing='ij')
    px = origins[:, 0:1] + gx.reshape(1, P)                     # (T, P)
    py = origins[:, 1:2] + gy.reshape(1, P)
    dx = px[:, None, :] - slots[:, :, 0:1]                      # (T, K, P)
    dy = py[:, None, :] - slots[:, :, 1:2]
    ca, cb, cc = slots[:, :, 2:3], slots[:, :, 3:4], slots[:, :, 4:5]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    power = torch.minimum(power, power.new_zeros(()))
    a_raw = slots[:, :, 5:6] * torch.exp(power)
    valid = (torch.arange(k, device=device)[None, :] <
             counts[:, None])[..., None]
    return torch.where((a_raw > ALPHA_MIN) & valid,
                       torch.minimum(a_raw, a_raw.new_full((), ALPHA_MAX)),
                       a_raw.new_zeros(()))


def _composite_plain(slots: torch.Tensor, counts: torch.Tensor,
                     origins: torch.Tensor) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """slots (T, K, 10), counts (T,), origins (T, 2) -> ((T, 5, P) composite,
    (T, K, P) exclusive transmittance before each entry); the oracle
    ``_composite_jnp`` (:322), op for op."""
    alpha = _alpha_plain(slots, counts, origins)
    trans = torch.cumprod(1.0 - alpha, dim=1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=1)
    w = trans * alpha
    rgb = torch.einsum('tkp,tkc->tcp', w, slots[:, :, 6:9])
    acc = w.sum(dim=1, keepdim=True)
    dep = torch.einsum('tkp,tk->tp', w, slots[:, :, 9])[:, None]
    return torch.cat([rgb, acc, dep], dim=1), trans


def _slots(sorted_mat: torch.Tensor, starts: torch.Tensor, tiles_x: int,
           k: int, first: int, last: int) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The (last - first, k, 10) slot windows of tiles [first, last) and
    their stream indices (``_cs_jnp``'s dynamic slices, :783-792)."""
    packed = sorted_mat.shape[0] == 8
    ent = sorted_mat.T
    idx = starts[first:last].long()[:, None] + torch.arange(
        k, device=sorted_mat.device)
    rows = ent[idx]
    if packed:
        rows = _unpack_stream(rows.reshape(-1, 8)).reshape(*idx.shape, 10)
    slots = rows[..., :10]
    if packed:
        # Tile-relative means -> absolute pixels (every valid row of slot t
        # belongs to tile t).
        origins = _tile_origins(last, tiles_x, sorted_mat.device)[first:]
        slots = torch.cat([slots[..., 0:2] + origins[:, None, :],
                           slots[..., 2:]], dim=-1)
    return slots, idx


def _cs_plain(sorted_mat: torch.Tensor, starts: torch.Tensor,
              counts: torch.Tensor, tiles_x: int, num_tiles: int, k: int,
              first: int = 0, last: int | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain composite of tiles [first, last) (default all) from the sorted
    stream, either layout: ((n, 5, P), (n, K, P) transmittance)."""
    last = num_tiles if last is None else last
    slots, _ = _slots(sorted_mat, starts, tiles_x, k, first, last)
    origins = _tile_origins(last, tiles_x, sorted_mat.device)[first:]
    return _composite_plain(slots, torch.clamp(counts[first:last], max=k),
                            origins)


def gs_composite_fwd_plain(sorted_mat: torch.Tensor, starts: torch.Tensor,
                           counts: torch.Tensor, tiles_x: int,
                           num_tiles: int, k: int,
                           save_tacc: bool = True):
    """Plain forward, tile block by tile block: (T, 5, P) and, with
    ``save_tacc``, the transmittance at the start of every chunk of CH
    entries, (T, ceil(k/CH), P), as the kernel saves it."""
    outs, taccs = [], []
    with torch.no_grad():
        for first in range(0, num_tiles, _PLAIN_TILES):
            last = min(first + _PLAIN_TILES, num_tiles)
            out, trans = _cs_plain(sorted_mat, starts, counts, tiles_x,
                                   num_tiles, k, first, last)
            outs.append(out)
            if save_tacc:
                taccs.append(trans[:, ::CH].contiguous())
    out = torch.cat(outs) if outs else sorted_mat.new_zeros((0, OUT_ROWS,
                                                              P))
    if not save_tacc:
        return out
    tacc = torch.cat(taccs) if taccs else sorted_mat.new_zeros(
        (0, num_chunks(k), P))
    return out, tacc


def gs_composite_bwd_plain(sorted_mat: torch.Tensor, starts: torch.Tensor,
                           counts: torch.Tensor, dout: torch.Tensor,
                           tiles_x: int, num_tiles: int, k: int
                           ) -> torch.Tensor:
    """d sorted (16, E_pad) by autograd of ``_cs_plain``, tile block by tile
    block (the oracle's ``jax.vjp`` of ``_cs_jnp``, :821-823)."""
    if sorted_mat.shape[0] == 8:
        raise KernelError('the packed (serving) stream layout is not '
                          'differentiable; train with the 16-wide layout')
    ent_grad = torch.zeros((sorted_mat.shape[1], 10), dtype=torch.float32,
                           device=sorted_mat.device)
    mat = sorted_mat.detach()
    for first in range(0, num_tiles, _PLAIN_TILES):
        last = min(first + _PLAIN_TILES, num_tiles)
        with torch.no_grad():
            slots, idx = _slots(mat, starts, tiles_x, k, first, last)
        slots = slots.detach().requires_grad_(True)
        with torch.enable_grad():
            origins = _tile_origins(last, tiles_x, mat.device)[first:]
            out, _ = _composite_plain(
                slots, torch.clamp(counts[first:last], max=k), origins)
            (d_slots,) = torch.autograd.grad(out, slots, dout[first:last])
        ent_grad.index_add_(0, idx.reshape(-1), d_slots.reshape(-1, 10))
    d_sorted = torch.zeros_like(mat)
    d_sorted[:10] = ent_grad.T
    return d_sorted


def _check_stream(name: str, sorted_mat: torch.Tensor, width: int,
                  starts: torch.Tensor, counts: torch.Tensor,
                  num_tiles: int, k: int) -> None:
    _kernels.require_cuda(name, sorted_mat, starts, counts,
                          dtypes=(torch.float32, torch.int32, torch.int32))
    if sorted_mat.ndim != 2 or sorted_mat.shape[0] != width:
        raise KernelError(f'{name}: sorted_mat must be ({width}, E_pad), got '
                          f'{tuple(sorted_mat.shape)}')
    if starts.shape != (num_tiles,) or counts.shape != (num_tiles,):
        raise KernelError(f'{name}: starts and counts must be ({num_tiles},)')
    if k <= 0 or sorted_mat.shape[1] < 3 * k:
        raise KernelError(f'{name}: the stream needs >= 3k guard entries')


def gs_composite_fwd(sorted_mat: torch.Tensor, starts: torch.Tensor,
                     counts: torch.Tensor, tiles_x: int, num_tiles: int,
                     k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """16-wide forward with saved transmittance: ((T, 5, P), (T, NC, P)),
    the transmittance defined on ``live_chunks``. CUDA tensors launch the
    kernel, CPU tensors take the plain version."""
    if sorted_mat.device.type == 'cpu':
        return gs_composite_fwd_plain(sorted_mat, starts, counts, tiles_x,
                                      num_tiles, k)
    name = 'gs_composite_fwd'
    _check_stream(name, sorted_mat, 16, starts, counts, num_tiles, k)
    dev = sorted_mat.device
    out = torch.empty((num_tiles, OUT_ROWS, P), dtype=torch.float32,
                      device=dev)
    tacc = torch.empty((num_tiles, num_chunks(k), P), dtype=torch.float32,
                       device=dev)
    code = _kernels.load_library().nerficg_gs_composite_fwd(
        sorted_mat.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        out.data_ptr(), tacc.data_ptr(), sorted_mat.shape[1], num_tiles,
        tiles_x, k, _kernels.stream_of(sorted_mat))
    _kernels.check(code, name)
    gs_composite_fwd.launches += 1
    return out, tacc


def gs_composite_fwd_packed(sorted_mat: torch.Tensor, starts: torch.Tensor,
                            counts: torch.Tensor, tiles_x: int,
                            num_tiles: int, k: int) -> torch.Tensor:
    """8-wide packed forward (serving): (T, 5, P). CUDA tensors launch the
    kernel, CPU tensors take the plain version."""
    if sorted_mat.device.type == 'cpu':
        return gs_composite_fwd_plain(sorted_mat, starts, counts, tiles_x,
                                      num_tiles, k, save_tacc=False)
    name = 'gs_composite_fwd_packed'
    _check_stream(name, sorted_mat, 8, starts, counts, num_tiles, k)
    out = torch.empty((num_tiles, OUT_ROWS, P), dtype=torch.float32,
                      device=sorted_mat.device)
    code = _kernels.load_library().nerficg_gs_composite_fwd_packed(
        sorted_mat.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        out.data_ptr(), sorted_mat.shape[1], num_tiles, tiles_x, k,
        _kernels.stream_of(sorted_mat))
    _kernels.check(code, name)
    gs_composite_fwd_packed.launches += 1
    return out


def gs_composite_bwd(sorted_mat: torch.Tensor, starts: torch.Tensor,
                     counts: torch.Tensor, tacc: torch.Tensor,
                     dout: torch.Tensor, tiles_x: int, num_tiles: int,
                     k: int) -> torch.Tensor:
    """d sorted (16, E_pad) from d out (T, 5, P) and the forward's saved
    transmittance. CUDA tensors launch the kernel, CPU tensors take the
    plain version (which recomputes the transmittance)."""
    if sorted_mat.device.type == 'cpu':
        return gs_composite_bwd_plain(sorted_mat, starts, counts, dout,
                                      tiles_x, num_tiles, k)
    name = 'gs_composite_bwd'
    _check_stream(name, sorted_mat, 16, starts, counts, num_tiles, k)
    _kernels.require_cuda(name, sorted_mat, tacc, dout,
                          dtypes=(torch.float32,) * 3)
    if tacc.shape != (num_tiles, num_chunks(k), P) or \
            dout.shape != (num_tiles, OUT_ROWS, P):
        raise KernelError(f'{name}: tacc must be ({num_tiles}, '
                          f'{num_chunks(k)}, {P}) and dout ({num_tiles}, '
                          f'{OUT_ROWS}, {P})')
    d_sorted = torch.empty_like(sorted_mat)
    code = _kernels.load_library().nerficg_gs_composite_bwd(
        sorted_mat.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        tacc.data_ptr(), dout.data_ptr(), d_sorted.data_ptr(),
        sorted_mat.shape[1], num_tiles, tiles_x, k,
        _kernels.stream_of(sorted_mat))
    _kernels.check(code, name)
    gs_composite_bwd.launches += 1
    return d_sorted


gs_composite_fwd.launches = 0
gs_composite_fwd_packed.launches = 0
gs_composite_bwd.launches = 0


class _CompositeSorted(torch.autograd.Function):
    """``composite_sorted`` (nerficg_tpu :738-833): the 16-wide forward saves
    the transmittance its backward starts from; the packed one is not
    differentiable."""

    @staticmethod
    def forward(ctx, sorted_mat, starts, counts, tiles_x, num_tiles, k):
        ctx.geometry = (tiles_x, num_tiles, k)
        ctx.packed = sorted_mat.shape[0] == 8
        if ctx.packed:
            return gs_composite_fwd_packed(sorted_mat, starts, counts,
                                           tiles_x, num_tiles, k)
        out, tacc = gs_composite_fwd(sorted_mat, starts, counts, tiles_x,
                                     num_tiles, k)
        ctx.save_for_backward(sorted_mat, starts, counts, tacc)
        return out

    @staticmethod
    def backward(ctx, dout):
        if ctx.packed:
            raise KernelError('the packed (serving) stream layout is not '
                              'differentiable; train with the 16-wide '
                              'layout')
        sorted_mat, starts, counts, tacc = ctx.saved_tensors
        d_sorted = gs_composite_bwd(sorted_mat, starts, counts, tacc,
                                    dout.contiguous(), *ctx.geometry)
        return d_sorted, None, None, None, None, None


def composite_sorted(sorted_mat: torch.Tensor, starts: torch.Tensor,
                     counts: torch.Tensor, tiles_x: int, num_tiles: int,
                     k: int) -> torch.Tensor:
    """(T, 5, P) composite of the sorted stream; differentiable in the
    16-wide ``sorted_mat``."""
    return _CompositeSorted.apply(sorted_mat.contiguous(),
                                  starts.to(torch.int32).contiguous(),
                                  counts.to(torch.int32).contiguous(),
                                  tiles_x, num_tiles, k)


# ---------------------------------------------------------------------------
# composite_tiles: the slot compositor (#13, #14)
# ---------------------------------------------------------------------------

def gs_tiles_fwd_plain(slots: torch.Tensor, counts: torch.Tensor,
                       origins: torch.Tensor) -> torch.Tensor:
    """Plain slot composite, ``_composite_plain`` tile block by tile block:
    (T, 8, P), rows 5-7 zero (the oracle ``_composite_jnp`` :322)."""
    outs = []
    with torch.no_grad():
        for first in range(0, slots.shape[0], _PLAIN_TILES):
            last = first + _PLAIN_TILES
            out, _ = _composite_plain(slots[first:last], counts[first:last],
                                      origins[first:last])
            outs.append(out)
    out = torch.cat(outs) if outs else slots.new_zeros((0, OUT_ROWS, P))
    return torch.nn.functional.pad(out, (0, 0, 0, SLOT_OUT_ROWS - OUT_ROWS))


def gs_tiles_bwd_plain(slots: torch.Tensor, counts: torch.Tensor,
                       origins: torch.Tensor,
                       dout: torch.Tensor) -> torch.Tensor:
    """d slots (T, K, 10) by autograd of ``_composite_plain``, tile block by
    tile block (``jax.vjp`` of the oracle, :398-399)."""
    grads = []
    for first in range(0, slots.shape[0], _PLAIN_TILES):
        last = first + _PLAIN_TILES
        block = slots[first:last].detach().requires_grad_(True)
        with torch.enable_grad():
            out, _ = _composite_plain(block, counts[first:last],
                                      origins[first:last])
            (d_block,) = torch.autograd.grad(out, block,
                                             dout[first:last, :OUT_ROWS])
        grads.append(d_block)
    return torch.cat(grads) if grads else torch.zeros_like(slots)


def _check_slots(name: str, slots: torch.Tensor, counts: torch.Tensor,
                 origins: torch.Tensor) -> None:
    _kernels.require_cuda(name, slots, counts, origins,
                          dtypes=(torch.float32, torch.int32, torch.float32))
    t = slots.shape[0]
    if slots.ndim != 3 or slots.shape[2] != 10 or counts.shape != (t,) or \
            origins.shape != (t, 2):
        raise KernelError(f'{name}: slots must be (T, K, 10), counts (T,) '
                          f'and origins (T, 2), got {tuple(slots.shape)}, '
                          f'{tuple(counts.shape)}, {tuple(origins.shape)}')


def gs_tiles_fwd(slots: torch.Tensor, counts: torch.Tensor,
                 origins: torch.Tensor) -> torch.Tensor:
    """Slot composite (T, 8, P) (#13). CUDA tensors launch the kernel, CPU
    tensors take ``gs_tiles_fwd_plain``."""
    if slots.device.type == 'cpu':
        return gs_tiles_fwd_plain(slots, counts, origins)
    name = 'gs_tiles_fwd'
    _check_slots(name, slots, counts, origins)
    num_tiles, k, _ = slots.shape
    out = torch.empty((num_tiles, SLOT_OUT_ROWS, P), dtype=torch.float32,
                      device=slots.device)
    code = _kernels.load_library().nerficg_gs_tiles_fwd(
        slots.data_ptr(), counts.data_ptr(), origins.data_ptr(),
        out.data_ptr(), num_tiles, k, _kernels.stream_of(slots))
    _kernels.check(code, name)
    gs_tiles_fwd.launches += 1
    return out


def gs_tiles_bwd(slots: torch.Tensor, counts: torch.Tensor,
                 origins: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """d slots (T, K, 10) from d out (T, 8, P) (#14), zero past each count.
    CUDA tensors launch the kernel (which recomputes each chunk's starting
    transmittance into a scratch buffer first), CPU tensors take
    ``gs_tiles_bwd_plain``."""
    if slots.device.type == 'cpu':
        return gs_tiles_bwd_plain(slots, counts, origins, dout)
    name = 'gs_tiles_bwd'
    _check_slots(name, slots, counts, origins)
    num_tiles, k, _ = slots.shape
    _kernels.require_cuda(name, slots, dout, dtypes=(torch.float32,) * 2)
    if dout.shape != (num_tiles, SLOT_OUT_ROWS, P):
        raise KernelError(f'{name}: dout must be ({num_tiles}, '
                          f'{SLOT_OUT_ROWS}, {P}), got {tuple(dout.shape)}')
    tacc = torch.empty((num_tiles, num_chunks(k), P), dtype=torch.float32,
                       device=slots.device)
    d_slots = torch.empty_like(slots)
    code = _kernels.load_library().nerficg_gs_tiles_bwd(
        slots.data_ptr(), counts.data_ptr(), origins.data_ptr(),
        tacc.data_ptr(), dout.data_ptr(), d_slots.data_ptr(), num_tiles, k,
        _kernels.stream_of(slots))
    _kernels.check(code, name)
    gs_tiles_bwd.launches += 1
    return d_slots


gs_tiles_fwd.launches = 0
gs_tiles_bwd.launches = 0


class _CompositeTiles(torch.autograd.Function):
    """``composite_tiles`` (nerficg_tpu :361-403): #13 forward, #14
    backward."""

    @staticmethod
    def forward(ctx, slots, counts, origins):
        ctx.save_for_backward(slots, counts, origins)
        return gs_tiles_fwd(slots, counts, origins)

    @staticmethod
    def backward(ctx, dout):
        slots, counts, origins = ctx.saved_tensors
        return gs_tiles_bwd(slots, counts, origins, dout.contiguous()), \
            None, None


def composite_tiles(slots: torch.Tensor, counts: torch.Tensor,
                    origins: torch.Tensor) -> torch.Tensor:
    """Per-tile compositing of slot windows: slots (T, K, 10) f32 rows [mx,
    my, ca, cb, cc, op, r, g, b, depth], counts (T,) (a tile composites its
    first min(count, K) slots), origins (T, 2) f32 pixel origins -> (T, 8,
    P) rows [r, g, b, acc, depth, 0, 0, 0]; differentiable in ``slots``."""
    return _CompositeTiles.apply(slots.contiguous(),
                                 counts.to(torch.int32).contiguous(),
                                 origins.to(torch.float32).contiguous())
