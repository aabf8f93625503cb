"""Plain PyTorch vanilla NeRF: rays, sampling, both MLPs, the compositor,
the loss and Adam.

A frozen copy of the published method as the port runs it
(``methods/nerf``, ``ops/sampling.py``, ``ops/compositing.py``,
``ops/encoding.py``): stratified coarse samples, fine samples from the
coarse weights' PDF (detached), the coarse and fine samples merged in depth
order, 8 x 256 ReLU trunks with the position encoding concatenated again
before the skip layer, volume rendering with the last interval ending at
``far``, colour MSE + coarse MSE. The linear layers multiply operands
rounded to the configuration's operand type (bfloat16) in float32 with TF32
off; ``operand_dtype`` float8 e4m3 is the lower-precision control. It
imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

__all__ = ['frequency_encode', 'mlp', 'render_rays', 'train_loss',
           'block_leaves']


def frequency_encode(x: torch.Tensor, num_frequencies: int) -> torch.Tensor:
    """[x, sin(2^k pi x), cos(2^k pi x)] with, per k, the three sines then
    the three cosines."""
    freqs = (2.0 ** torch.arange(num_frequencies, dtype=torch.float32,
                                 device=x.device)) * math.pi
    scaled = x[..., None, :] * freqs[:, None]
    enc = torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1)
    return torch.cat([x, enc.reshape(*x.shape[:-1], -1)], dim=-1)


def _linear(x, w, b, operand_dtype):
    return x.to(operand_dtype).float() @ w.to(operand_dtype).float().T + b


def block_leaves(leaves: dict, block: str) -> dict:
    prefix = f'{block}.'
    return {k[len(prefix):]: v for k, v in leaves.items()
            if k.startswith(prefix)}


def mlp(p: dict, positions, directions, cfg: dict, operand_dtype):
    """One block: (N, 3) positions and unit directions -> density (N,),
    rgb (N, 3)."""
    pos_enc = frequency_encode(positions, int(cfg['POSITION_FREQUENCIES']))
    dir_enc = frequency_encode(directions, int(cfg['DIRECTION_FREQUENCIES']))
    x = pos_enc
    for i in range(int(cfg['NUM_LAYERS'])):
        if i == int(cfg['SKIP_LAYER']):
            x = torch.cat([x, pos_enc], -1)
        x = torch.relu(_linear(x, p[f'trunk.{i}.weight'],
                               p[f'trunk.{i}.bias'], operand_dtype))
    density = torch.relu(_linear(x, p['density.weight'], p['density.bias'],
                                 operand_dtype)[..., 0])
    feature = _linear(x, p['feature.weight'], p['feature.bias'],
                      operand_dtype)
    h = torch.relu(_linear(torch.cat([feature, dir_enc], -1),
                           p['color_hidden.weight'], p['color_hidden.bias'],
                           operand_dtype))
    return density, torch.sigmoid(_linear(h, p['color_out.weight'],
                                          p['color_out.bias'],
                                          operand_dtype))


def _composite(rgb, density, t, far, background):
    deltas = torch.diff(t, dim=-1, append=far * torch.ones_like(t[:, :1]))
    alpha = 1.0 - torch.exp(-density * deltas)
    trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    w = trans * alpha
    acc = w.sum(-1, keepdim=True)
    out = torch.einsum('rs,rsc->rc', w, rgb) + (1.0 - acc) * background
    return out, w


def _sample_pdf(bins, weights, u, eps=1e-5):
    weights = weights + eps
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    last = cdf.shape[-1] - 1
    below = torch.clamp(idx - 1, 0, last)
    above = torch.clamp(idx, 0, last)
    cdf_b, cdf_a = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    bin_last = bins.shape[-1] - 1
    bins_b = torch.gather(bins, -1, torch.clamp(below, 0, bin_last))
    bins_a = torch.gather(bins, -1, torch.clamp(above, 0, bin_last))
    span = cdf_a - cdf_b
    t = (u - cdf_b) / torch.where(span < eps, 1.0, span)
    return bins_b + t * (bins_a - bins_b)


def render_rays(leaves: dict, origins, directions, near: float, far: float,
                background, u_coarse, u_fine, cfg: dict, operand_dtype):
    """Coarse and fine colour of a batch of rays from given uniforms."""
    rays = origins.shape[0]
    n_coarse = u_coarse.shape[1]
    bins = torch.linspace(0.0, 1.0, n_coarse + 1, device=origins.device)
    t = bins[:-1][None, :] + (bins[1:] - bins[:-1])[None, :] * u_coarse
    t_coarse = near + (far - near) * t
    d = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)

    def block(name, t):
        s = t.shape[1]
        pos = origins[:, None, :] + d[:, None, :] * t[..., None]
        flat_d = d[:, None, :].expand(rays, s, 3).reshape(-1, 3)
        dens, rgb = mlp(block_leaves(leaves, name), pos.reshape(-1, 3),
                        flat_d, cfg, operand_dtype)
        return _composite(rgb.reshape(rays, s, 3), dens.reshape(rays, s), t,
                          far, background)

    coarse_rgb, w = block('coarse', t_coarse)
    mids = 0.5 * (t_coarse[:, 1:] + t_coarse[:, :-1])
    pdf_bins = torch.cat([t_coarse[:, :1], mids, t_coarse[:, -1:]], -1)
    t_fine = _sample_pdf(pdf_bins, w.detach(), u_fine)
    t_all = torch.sort(torch.cat([t_coarse, t_fine], -1), -1).values
    fine_rgb, _ = block('fine', t_all)
    return coarse_rgb, fine_rgb


def train_loss(coarse_rgb, fine_rgb, target, coarse_weight: float):
    return torch.mean((fine_rgb - target) ** 2) + \
        coarse_weight * torch.mean((coarse_rgb - target) ** 2)
