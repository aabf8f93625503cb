"""Plain PyTorch 3D Gaussian Splatting: the render and the loss.

A frozen copy of the port's plain versions, kept here so that no change to
the program moves the yardstick: the frontend (``ops/gaussian.py``,
``ops/encoding.py`` SH), the tile rasterizer (``ops/gs_rasterize.py``: the
linearised rect cover of D tiles, the circle-vs-tile cull, the stable
(tile, depth) sort, the packed serving key and words) and the compositor's
plain path (``ops/gs_tiles_kernel.py``: each tile composites the first
min(count, k) entries of its segment, alpha clamped to [1/255, 0.99]),
and L1 + DSSIM (``optim/losses.py``, ``optim/metrics.py``). It imports
nothing of the program.

Every floating-point step follows the dtype of its inputs, so the same code
computed in bfloat16 is the lower-precision control. The sort keys and the
packed words are always taken from float32 values, as the program takes
them.
"""

from __future__ import annotations

import math

import torch

__all__ = ['activations', 'frontend', 'entry_stream', 'composite',
           'assemble', 'render', 'dssim', 'train_loss',
           'camera_extent', 'position_lr', 'TILE', 'P', 'pair_counts']

TILE = 16
P = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
MEANS_FP_SCALE = 32.0
MEANS_FP_BIAS = 1024.0
BLOCK_TILES = 256          # tiles a composite block holds (64 MiB f32 each)
SH_C0 = 0.28209479177387814
_SH_C1 = 0.4886025119029199
_SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
          -1.0925484305920792, 0.5462742152960396)
_SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
          0.3731763325901154, -0.4570457994644658, 1.445305721320277,
          -0.5900435899266435)


# -- frontend --------------------------------------------------------------------

def activations(raw: dict) -> dict:
    """Raw leaves -> scales, unit quaternions, opacities (N,), features."""
    q = raw['rotations']
    return {
        'positions': raw['positions'],
        'scales': torch.exp(torch.clamp(raw['scales'], -15.0, 10.0)),
        'rotations': q * torch.rsqrt(torch.clamp((q * q).sum(-1,
                                                            keepdim=True),
                                                 min=1e-12)),
        'opacities': torch.sigmoid(raw['opacities'])[:, 0],
        'features': torch.cat([raw['features_dc'], raw['features_rest']], 1)}


def _rotation(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], dim=-2)


def _sh_basis(d: torch.Tensor, degree: int) -> torch.Tensor:
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    out = [torch.full_like(x, SH_C0)]
    if degree > 1:
        out += [-_SH_C1 * y, _SH_C1 * z, -_SH_C1 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [_SH_C2[0] * xy, _SH_C2[1] * yz,
                _SH_C2[2] * (2.0 * zz - xx - yy), _SH_C2[3] * xz,
                _SH_C2[4] * (xx - yy)]
    if degree > 3:
        out += [_SH_C3[0] * y * (3.0 * xx - yy), _SH_C3[1] * xy * z,
                _SH_C3[2] * y * (4.0 * zz - xx - yy),
                _SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                _SH_C3[4] * x * (4.0 * zz - xx - yy),
                _SH_C3[5] * z * (xx - yy), _SH_C3[6] * x * (xx - 3.0 * yy)]
    return torch.stack(out, -1)


def frontend(raw: dict, w2c: torch.Tensor, cam_pos: torch.Tensor,
             intrinsics: tuple, sh_degree: int, low_pass: float,
             near: float = 0.01) -> dict:
    """Covariances, the EWA projection with the tan-fov clamp, SH colour:
    the rasterizer's inputs per Gaussian."""
    act = activations(raw)
    fx, fy, cx, cy, width, height = intrinsics
    m = _rotation(act['rotations']) * act['scales'][:, None, :]
    cov3d = m @ m.transpose(-1, -2)
    means = act['positions']
    w2c = w2c.to(means.dtype)
    cam = means @ w2c[:3, :3].T + w2c[:3, 3]
    x, y, z = cam[..., 0], cam[..., 1], cam[..., 2]
    in_front = z > near
    zs = torch.clamp(z, min=near)
    px = x / zs * fx + cx
    py = y / zs * fy + cy
    lim_x = 1.3 * (0.5 * width / fx)
    lim_y = 1.3 * (0.5 * height / fy)
    tx = torch.clamp(x / zs, -lim_x, lim_x) * zs
    ty = torch.clamp(y / zs, -lim_y, lim_y) * zs
    zero = torch.zeros_like(zs)
    jac = torch.stack([torch.stack([fx / zs, zero, -fx * tx / (zs ** 2)], -1),
                       torch.stack([zero, fy / zs, -fy * ty / (zs ** 2)], -1)],
                      dim=-2)
    t = jac @ w2c[:3, :3]
    cov2d = t @ cov3d @ t.transpose(-1, -2)
    a = cov2d[..., 0, 0] + low_pass
    b = cov2d[..., 0, 1]
    c = cov2d[..., 1, 1] + low_pass
    det = a * c - b * b
    det_safe = torch.clamp(det, min=1e-12)
    conics = torch.stack([c / det_safe, -b / det_safe, a / det_safe], -1)
    mid = 0.5 * (a + c)
    eig1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radii = torch.ceil(3.0 * torch.sqrt(torch.clamp(eig1, min=0.0)))
    visible = in_front & (det > 0) & (px + radii > 0) & \
        (px - radii < width) & (py + radii > 0) & (py - radii < height)
    d = means - cam_pos.to(means.dtype)
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-8)
    k = sh_degree * sh_degree
    colors = torch.einsum('nkc,nk->nc', act['features'][:, :k],
                          _sh_basis(d, sh_degree)[:, :k])
    return {'means2d': torch.stack([px, py], -1), 'depths': z,
            'conics': conics, 'radii': torch.where(visible, radii, 0.0),
            'colors': torch.clamp(colors + 0.5, min=0.0),
            'opacities': act['opacities'], 'visible': visible}


# -- rasterizer ----------------------------------------------------------------------

def _tile_cell(v: torch.Tensor, hi: int) -> torch.Tensor:
    cell = torch.div(v.float(), TILE, rounding_mode='floor')
    cell = torch.clamp(cell, -2.0 ** 30, 2.0 ** 30)
    return torch.clamp(cell.to(torch.int32), 0, hi)


def _segments(sorted_tile: torch.Tensor, num_tiles: int):
    edges = torch.searchsorted(
        sorted_tile, torch.arange(num_tiles + 1, dtype=sorted_tile.dtype,
                                  device=sorted_tile.device), side='left')
    return edges[:-1], edges[1:] - edges[:-1]


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    return x.float().contiguous().view(torch.int32).long()


def _depth_key(tile: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """(tile << 32) | order-preserving u32 of the f32 depth (-0 as +0)."""
    depth = depth.float()
    depth = torch.where(depth == 0, torch.zeros_like(depth), depth)
    bits = _f32_bits(depth)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits) + 2 ** 31
    return (tile.long() << 32) | ordered


def _as_f32(bits: torch.Tensor) -> torch.Tensor:
    signed = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return signed.to(torch.int32).view(torch.float32)


def _bf16_word(a: torch.Tensor) -> torch.Tensor:
    return a.float().to(torch.bfloat16).view(torch.int16).long() & 0xFFFF


def entry_stream(fe: dict, width: int, height: int, max_tiles: int, k: int,
                 packed: bool = False) -> dict:
    """The (tile, depth)-sorted entries every tile composites: 'slots'
    source (entry attributes (E, 10) in sorted order), 'starts', 'counts'
    (T,), the geometry and the truncation counters. D = ``max_tiles``
    entries per Gaussian over its pixel rect, culled by the circle test;
    with ``packed`` the serving stream: one u32 key of the tile and the
    top bits of the depth, attributes rounded as its packed words hold
    them (u16.u16 tile-relative means in 1/32 px, bf16 pairs)."""
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    num_tiles = tiles_x * tiles_y
    device = fe['means2d'].device
    m2d = fe['means2d'].detach().float()
    rad = fe['radii'].detach().float()
    t_min_x = _tile_cell(m2d[:, 0] - rad, tiles_x - 1)
    t_max_x = _tile_cell(m2d[:, 0] + rad, tiles_x - 1)
    t_min_y = _tile_cell(m2d[:, 1] - rad, tiles_y - 1)
    t_max_y = _tile_cell(m2d[:, 1] + rad, tiles_y - 1)
    rect_w = t_max_x - t_min_x + 1
    j = torch.arange(max_tiles, dtype=torch.int32, device=device)[:, None]
    tx = t_min_x[None, :] + j % rect_w[None, :]
    ty = t_min_y[None, :] + torch.div(j, rect_w[None, :],
                                      rounding_mode='floor')
    valid = (tx <= t_max_x[None, :]) & (ty <= t_max_y[None, :]) & \
        fe['visible'][None, :] & (rad[None, :] > 0)
    x0 = tx.float() * TILE
    y0 = ty.float() * TILE
    cpx = torch.minimum(torch.maximum(m2d[None, :, 0], x0), x0 + TILE)
    cpy = torch.minimum(torch.maximum(m2d[None, :, 1], y0), y0 + TILE)
    dcx = cpx - m2d[None, :, 0]
    dcy = cpy - m2d[None, :, 1]
    valid &= (dcx * dcx + dcy * dcy) <= (rad * rad)[None, :]
    tile = torch.where(valid, ty * tiles_x + tx,
                       torch.full_like(tx, num_tiles))
    dup, n = tile.shape
    rect_h = t_max_y - t_min_y + 1
    overflow = ((rect_w * rect_h > max_tiles) & fe['visible'] &
                (rad > 0)).sum()
    if packed:
        depth_bits = 32 - int(num_tiles + 1).bit_length()
        dep = (_f32_bits(fe['depths']) & 0xFFFFFFFF) >> (32 - depth_bits)
        key = ((tile.long() << depth_bits) | dep[None, :]).reshape(-1)
        order = torch.sort(key, stable=True).indices
        sorted_tile = (key[order] >> depth_bits)
        gauss = order % n
        span = MEANS_FP_BIAS * MEANS_FP_SCALE
        ent_tx = tx.reshape(-1)[order].float()
        ent_ty = ty.reshape(-1)[order].float()

        def fixed(mean, cell):
            q = torch.round((mean - cell * TILE) * MEANS_FP_SCALE + span)
            return torch.clamp(q, 0.0, 65535.0) / MEANS_FP_SCALE \
                - MEANS_FP_BIAS + cell * TILE

        def bf16(a):
            return _as_f32(_bf16_word(a) << 16)

        attrs = torch.stack([
            fixed(m2d[gauss, 0], ent_tx), fixed(m2d[gauss, 1], ent_ty),
            bf16(fe['conics'][gauss, 0]), bf16(fe['conics'][gauss, 1]),
            bf16(fe['conics'][gauss, 2]), bf16(fe['opacities'][gauss]),
            bf16(fe['colors'][gauss, 0]), bf16(fe['colors'][gauss, 1]),
            bf16(fe['colors'][gauss, 2]), bf16(fe['depths'][gauss])], 1)
    else:
        key = _depth_key(tile.reshape(-1), fe['depths'].detach()[None, :]
                         .expand(dup, -1).reshape(-1))
        order = torch.sort(key, stable=True).indices
        sorted_tile = tile.reshape(-1)[order]
        gauss = order % n
        src = torch.stack([
            fe['means2d'][:, 0], fe['means2d'][:, 1], fe['conics'][:, 0],
            fe['conics'][:, 1], fe['conics'][:, 2], fe['opacities'],
            fe['colors'][:, 0], fe['colors'][:, 1], fe['colors'][:, 2],
            fe['depths']], 1)
        attrs = src[gauss]
    starts, counts = _segments(sorted_tile.to(torch.int64), num_tiles)
    return {'attrs': attrs, 'starts': starts, 'counts': counts,
            'tiles_x': tiles_x, 'num_tiles': num_tiles,
            'overflow_gaussians': overflow,
            'overflow_entries': torch.clamp(counts - k, min=0).sum(),
            'entries': int(valid.sum())}


# -- compositor ------------------------------------------------------------------------

def _origins(first: int, last: int, tiles_x: int, device) -> torch.Tensor:
    idx = torch.arange(first, last, dtype=torch.float32, device=device)
    return torch.stack([torch.remainder(idx, tiles_x) * TILE,
                        torch.div(idx, tiles_x, rounding_mode='floor')
                        * TILE], -1)


def _alpha(slots: torch.Tensor, counts: torch.Tensor,
           origins: torch.Tensor) -> torch.Tensor:
    """(T, K, P) alpha of every (slot, pixel), zero past each count and
    under 1/255, clamped to 0.99."""
    k = slots.shape[1]
    dtype = slots.dtype
    pix = torch.arange(TILE, dtype=torch.float32, device=slots.device) + 0.5
    gy, gx = torch.meshgrid(pix, pix, indexing='ij')
    px = (origins[:, 0:1] + gx.reshape(1, P)).to(dtype)
    py = (origins[:, 1:2] + gy.reshape(1, P)).to(dtype)
    dx = px[:, None, :] - slots[:, :, 0:1]
    dy = py[:, None, :] - slots[:, :, 1:2]
    ca, cb, cc = slots[:, :, 2:3], slots[:, :, 3:4], slots[:, :, 4:5]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    power = torch.minimum(power, power.new_zeros(()))
    a_raw = slots[:, :, 5:6] * torch.exp(power)
    inside = (torch.arange(k, device=slots.device)[None, :] <
              counts[:, None])[..., None]
    return torch.where((a_raw > ALPHA_MIN) & inside,
                       torch.minimum(a_raw, a_raw.new_full((), ALPHA_MAX)),
                       a_raw.new_zeros(()))


def _composite_block(slots, counts, origins) -> torch.Tensor:
    alpha = _alpha(slots, counts, origins)
    trans = torch.cumprod(1.0 - alpha, dim=1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=1)
    w = trans * alpha
    rgb = torch.einsum('tkp,tkc->tcp', w, slots[:, :, 6:9])
    acc = w.sum(dim=1, keepdim=True)
    dep = torch.einsum('tkp,tk->tp', w, slots[:, :, 9])[:, None]
    return torch.cat([rgb, acc, dep], dim=1)


def _block_slots(attrs, starts, k, first, last):
    idx = starts[first:last, None] + torch.arange(k, device=attrs.device)
    idx = torch.clamp(idx, max=attrs.shape[0] - 1)
    return attrs[idx], idx


class _Composite(torch.autograd.Function):
    """The composite of every tile, block by block of ``BLOCK_TILES``; the
    backward recomputes each block under autograd."""

    @staticmethod
    def forward(ctx, attrs, starts, counts, tiles_x, num_tiles, k):
        ctx.geometry = (tiles_x, num_tiles, k)
        ctx.save_for_backward(attrs, starts, counts)
        outs = []
        for first in range(0, num_tiles, BLOCK_TILES):
            last = min(first + BLOCK_TILES, num_tiles)
            slots, _ = _block_slots(attrs, starts, k, first, last)
            outs.append(_composite_block(
                slots, torch.clamp(counts[first:last], max=k),
                _origins(first, last, tiles_x, attrs.device)))
        return torch.cat(outs)

    @staticmethod
    def backward(ctx, dout):
        attrs, starts, counts = ctx.saved_tensors
        tiles_x, num_tiles, k = ctx.geometry
        grad = torch.zeros_like(attrs)
        for first in range(0, num_tiles, BLOCK_TILES):
            last = min(first + BLOCK_TILES, num_tiles)
            with torch.no_grad():
                slots, idx = _block_slots(attrs, starts, k, first, last)
            slots = slots.detach().requires_grad_(True)
            with torch.enable_grad():
                out = _composite_block(
                    slots, torch.clamp(counts[first:last], max=k),
                    _origins(first, last, tiles_x, attrs.device))
                (d_slots,) = torch.autograd.grad(out, slots,
                                                 dout[first:last])
            # Slots past a tile's count carry zero gradient.
            grad.index_add_(0, idx.reshape(-1),
                            d_slots.reshape(-1, attrs.shape[1]))
        return grad, None, None, None, None, None


def composite(stream: dict, k: int) -> torch.Tensor:
    """(T, 5, P) rows [r, g, b, acc, depth] of every tile."""
    attrs = stream['attrs']
    if attrs.shape[0] == 0:
        attrs = attrs.new_zeros((1, attrs.shape[1]))
    return _Composite.apply(attrs, stream['starts'], stream['counts'],
                            stream['tiles_x'], stream['num_tiles'], k)


def assemble(out: torch.Tensor, width: int, height: int,
             background: torch.Tensor) -> dict:
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)

    def to_image(data, chs):
        img = data.reshape(tiles_y, tiles_x, TILE, TILE, chs)
        img = img.permute(0, 2, 1, 3, 4).reshape(tiles_y * TILE,
                                                 tiles_x * TILE, chs)
        return img[:height, :width]

    image = to_image(out[:, 0:3].transpose(1, 2), 3)
    alpha = to_image(out[:, 3, :, None], 1)
    return {'rgb': image + (1.0 - alpha) * background.to(image.dtype),
            'alpha': alpha}


def render(raw: dict, view: dict, cfg: dict, sh_degree: int,
           packed: bool = False) -> dict:
    """One frame, {'rgb', 'alpha'}: ``view`` holds 'w2c', 'cam_pos',
    'intrinsics', 'background'; ``cfg`` the RENDERER section."""
    fe = frontend(raw, view['w2c'], view['cam_pos'], view['intrinsics'],
                  sh_degree, float(cfg['LOW_PASS_FILTER']))
    width, height = view['intrinsics'][4], view['intrinsics'][5]
    k = int(cfg['MAX_PER_TILE'])
    stream = entry_stream(fe, width, height,
                          int(cfg['MAX_TILES_PER_GAUSSIAN']), k, packed)
    return assemble(composite(stream, k), width, height, view['background'])


# -- loss and optimizer -----------------------------------------------------------

def _gaussian_window(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    return g / g.sum()


def _filter(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    k = kernel.shape[0]
    x = img.permute(2, 0, 1)
    w_out = x.shape[2] - k + 1
    acc = kernel[0] * x[:, :, 0:w_out]
    for i in range(1, k):
        acc = acc + kernel[i] * x[:, :, i:i + w_out]
    h_out = x.shape[1] - k + 1
    out = kernel[0] * acc[:, 0:h_out]
    for i in range(1, k):
        out = out + kernel[i] * acc[:, i:i + h_out]
    return out.permute(1, 2, 0)


def dssim(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(1 - SSIM) / 2 with an 11-tap Gaussian window (sigma 1.5), valid
    padding, c1 = 0.01^2, c2 = 0.03^2."""
    kernel = _gaussian_window().to(pred.device)
    mu_p, mu_t = _filter(pred, kernel), _filter(target, kernel)
    var_p = _filter(pred * pred, kernel) - mu_p * mu_p
    var_t = _filter(target * target, kernel) - mu_t * mu_t
    cov = _filter(pred * target, kernel) - mu_p * mu_t
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim = ((2 * mu_p * mu_t + c1) * (2 * cov + c2)) / \
        ((mu_p * mu_p + mu_t * mu_t + c1) * (var_p + var_t + c2))
    return (1.0 - ssim.mean()) / 2.0


def train_loss(rgb: torch.Tensor, target: torch.Tensor,
               lambda_dssim: float) -> torch.Tensor:
    return (1.0 - lambda_dssim) * torch.mean(torch.abs(rgb - target)) + \
        lambda_dssim * dssim(rgb, target)


def camera_extent(positions) -> float:
    """1.1 x the largest camera distance from the cameras' mean."""
    import numpy as np
    pos = np.asarray(positions, np.float64)
    return 1.1 * float(np.linalg.norm(pos - pos.mean(0), axis=-1).max()) \
        or 1.0


def position_lr(init: float, final: float, max_steps: int, step: int) -> float:
    """Log-linear from init to final over max_steps."""
    t = min(max(step / max(max_steps, 1), 0.0), 1.0)
    return math.exp((1.0 - t) * math.log(init) + t * math.log(final))


def pair_counts(stream: dict, k: int) -> dict:
    """(entry, pixel) pairs of a composite: ``entries`` composited (each
    tile's first min(count, k)) and ``passing`` pairs whose alpha passes
    1/255: the compositor's work."""
    attrs, starts, counts = stream['attrs'].detach().float(), \
        stream['starts'], stream['counts']
    passing = 0
    with torch.no_grad():
        for first in range(0, stream['num_tiles'], BLOCK_TILES):
            last = min(first + BLOCK_TILES, stream['num_tiles'])
            slots, _ = _block_slots(attrs, starts, k, first, last)
            alpha = _alpha(slots, torch.clamp(counts[first:last], max=k),
                           _origins(first, last, stream['tiles_x'],
                                    attrs.device))
            passing += int((alpha > 0).sum())
    return {'entries': int(torch.clamp(counts, max=k).sum()),
            'passing': passing}
