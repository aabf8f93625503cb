"""Plain PyTorch Mip-NeRF 360: s-space resampling, conical frustums as
Gaussians, the contraction, the integrated positional encoding, both MLPs,
the compositor, the three losses, the clip and Adam's inputs.

Written from the paper (Barron et al., CVPR 2022, §2-§4) and the released
code's defaults (google-research/multinerf ``configs/360.gin``), as the
configuration runs it: distances t in [near, far] mapped to s in [0, 1]
by g(t) = 1/t; round 0 one interval of weight 1; each round's interval
centres at the stratified quantiles (i + j) / n of the previous round's
normalised histogram, one jitter j per ray, its edges at the midpoints,
the outer two mirrored and clamped to [0, 1]; each interval's frustum
Gaussian (mip-NeRF's t_mu / t_d form), contracted with its covariance
linearised at the mean, its axis-aligned variances encoded at degrees
0..L-1; a proposal MLP (ReLU, no skip) and the NeRF MLP (ReLU, the
encoding again before the skip layer, a bottleneck, the view branch);
densities softplus(raw - 1), colours sigmoid padded by 0.001; weights
from alpha compositing over t-lengths (the transmittance's exclusive
product with NeRF's 1e-10), black background; the loss Charbonnier +
0.01 x distortion (written as its double sum) + per proposal round the
interlevel loss against the NeRF round held fixed (its bound as a sum
over every overlapping pair of intervals); gradients clipped to a global
norm. The linear layers multiply operands rounded to the configuration's
operand type (bfloat16) in float32 with TF32 off; ``operand_dtype``
float8 e4m3 is the lower-precision control. Blocks of rays add their
share of the batch's mean loss, so a step's gradients are the sums of
its blocks'. It imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

__all__ = ['mlp_leaves', 'render_rays', 'block_loss', 'clip', 'ray_radii']

_EPS = float(torch.finfo(torch.float32).eps)


def _mlp_dims(cfg: dict) -> dict:
    enc = 6 * int(cfg['POSITION_DEGREES'])
    dir_dim = 3 * (2 * int(cfg['DIRECTION_FREQUENCIES']) + 1)
    out = {}
    d = enc
    for i in range(int(cfg['PROPOSAL_LAYERS'])):
        out[f'proposal.trunk.{i}'] = (int(cfg['PROPOSAL_WIDTH']), d)
        d = int(cfg['PROPOSAL_WIDTH'])
    out['proposal.density'] = (1, d)
    width, d = int(cfg['WIDTH']), enc
    for i in range(int(cfg['NUM_LAYERS'])):
        if i == int(cfg['SKIP_LAYER']):
            d += enc
        out[f'nerf.trunk.{i}'] = (width, d)
        d = width
    bottleneck, view = int(cfg['BOTTLENECK_WIDTH']), int(cfg['VIEW_WIDTH'])
    out['nerf.density'] = (1, width)
    out['nerf.bottleneck'] = (bottleneck, width)
    out['nerf.view_hidden'] = (view, bottleneck + dir_dim)
    out['nerf.rgb'] = (3, view)
    return out


def mlp_leaves(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of every leaf of both MLPs: each linear layer's
    weight (out, in), then its bias."""
    leaves = []
    for name, (out_dim, in_dim) in _mlp_dims(cfg).items():
        leaves += [(f'{name}.weight', (out_dim, in_dim)),
                   (f'{name}.bias', (out_dim,))]
    return leaves


def ray_radii(local_dirs, local_dirs_right, local_dirs_down):
    """Base radii of the pixels' cones: 2/sqrt(12) times the mean distance
    from a pixel's unit direction to its right and lower neighbours'."""
    def unit(d):
        return d / torch.linalg.norm(d, dim=-1, keepdim=True)
    here = unit(local_dirs)
    dx = torch.linalg.norm(unit(local_dirs_right) - here, dim=-1)
    dy = torch.linalg.norm(unit(local_dirs_down) - here, dim=-1)
    return (dx + dy) / 2.0 * 2.0 / math.sqrt(12.0)


# -- sampling ----------------------------------------------------------------

def _resample(edges, weights, n, jitter):
    """n new intervals (R, n + 1) from the histogram (edges, weights)."""
    q = (torch.arange(n, dtype=torch.float32, device=edges.device)[None]
         + jitter[:, None]) / n
    total = weights.sum(-1, keepdim=True)
    pdf = weights / torch.clamp(total, min=torch.finfo(torch.float32).tiny)
    cdf = torch.cat([torch.zeros_like(total),
                     torch.clamp(torch.cumsum(pdf[:, :-1], -1), max=1.0),
                     torch.ones_like(total)], -1)
    m = weights.shape[-1]
    # the interval j whose CDF range holds q: cdf[j] <= q < cdf[j + 1]
    j = (cdf[:, None, 1:-1] <= q[:, :, None]).sum(-1).clamp(max=m - 1)
    c0 = torch.gather(cdf, 1, j)
    c1 = torch.gather(cdf, 1, j + 1)
    s0 = torch.gather(edges, 1, j)
    s1 = torch.gather(edges, 1, j + 1)
    frac = torch.where(c1 > c0, (q - c0) / torch.where(c1 > c0, c1 - c0, 1.0),
                       0.0).clamp(0.0, 1.0)
    centres = s0 + frac * (s1 - s0)
    mids = (centres[:, 1:] + centres[:, :-1]) / 2
    return torch.cat([(2 * centres[:, :1] - mids[:, :1]).clamp(min=0.0), mids,
                      (2 * centres[:, -1:] - mids[:, -1:]).clamp(max=1.0)], -1)


def _s_to_t(s, near, far):
    return 1.0 / (s / far + (1.0 - s) / near)


# -- the Gaussians -----------------------------------------------------------

def _frustums(origins, dirs, radii, t0, t1):
    mu, hw = (t0 + t1) / 2, (t1 - t0) / 2
    denom = torch.clamp(3 * mu ** 2 + hw ** 2, min=_EPS)
    t_mean = mu + 2 * mu * hw ** 2 / denom
    t_var = hw ** 2 / 3 - (4 / 15) * hw ** 4 * (12 * mu ** 2 - hw ** 2) \
        / denom ** 2
    r_var = radii[:, None] ** 2 * (mu ** 2 / 4 + (5 / 12) * hw ** 2
                                   - (4 / 15) * hw ** 4 / denom)
    means = origins[:, None] + t_mean[..., None] * dirs[:, None]
    dd = torch.einsum('ri,rj->rij', dirs, dirs)
    null = torch.eye(3, device=dirs.device) - dd / torch.clamp(
        (dirs ** 2).sum(-1), min=1e-10)[:, None, None]
    covs = t_var[..., None, None] * dd[:, None] + \
        r_var[..., None, None] * null[:, None]
    return means, covs


def _contract(means, covs):
    """Means and covariances through contract(x) = (2 - 1/|x|) x/|x|
    outside the unit ball, the covariances by J cov J^T."""
    n2 = torch.clamp((means ** 2).sum(-1), min=_EPS)
    n = torch.sqrt(n2)
    out = n2 > 1.0
    scale = torch.where(out, (2 - 1 / n) / n, 1.0)
    # d/dx [(2 - 1/n) x / n] = (2/n - 1/n^2) I + (2/n^3 - 2/n^2) x x^T / n
    a = torch.where(out, 2 / n - 1 / n2, 1.0)
    b = torch.where(out, (2 / n ** 3 - 2 / n2) / n, 0.0)
    jac = a[..., None, None] * torch.eye(3, device=means.device) + \
        b[..., None, None] * torch.einsum('...i,...j->...ij', means, means)
    covs = torch.einsum('...ij,...jk,...lk->...il', jac, covs, jac)
    return scale[..., None] * means, covs


def _ipe(means, variances, degrees):
    feats_sin, feats_cos = [], []
    for l in range(degrees):
        damp = torch.exp(-0.5 * 4.0 ** l * variances)
        feats_sin.append(torch.sin(2.0 ** l * means) * damp)
        feats_cos.append(torch.cos(2.0 ** l * means) * damp)
    return torch.cat(feats_sin + feats_cos, -1)


def _dir_encode(d, freqs):
    out = [d]
    sins, coss = [], []
    for k in range(freqs):
        sins.append(torch.sin(2.0 ** k * math.pi * d))
        coss.append(torch.cos(2.0 ** k * math.pi * d))
    for s, c in zip(sins, coss):
        out += [s, c]
    return torch.cat(out, -1)


# -- the MLPs ----------------------------------------------------------------

def _linear(p, name, x, operand_dtype):
    w = p[f'{name}.weight']
    return x.to(operand_dtype).float() @ w.to(operand_dtype).float().T + \
        p[f'{name}.bias']


def _proposal(p, x, cfg, operand_dtype):
    for i in range(int(cfg['PROPOSAL_LAYERS'])):
        x = torch.relu(_linear(p, f'proposal.trunk.{i}', x, operand_dtype))
    raw = _linear(p, 'proposal.density', x, operand_dtype)[:, 0]
    return torch.nn.functional.softplus(raw - 1.0)


def _nerf(p, x, dirs, cfg, operand_dtype):
    inputs = x
    for i in range(int(cfg['NUM_LAYERS'])):
        if i == int(cfg['SKIP_LAYER']):
            x = torch.cat([x, inputs], -1)
        x = torch.relu(_linear(p, f'nerf.trunk.{i}', x, operand_dtype))
    raw = _linear(p, 'nerf.density', x, operand_dtype)[:, 0]
    h = torch.cat([_linear(p, 'nerf.bottleneck', x, operand_dtype),
                   _dir_encode(dirs, int(cfg['DIRECTION_FREQUENCIES']))], -1)
    h = torch.relu(_linear(p, 'nerf.view_hidden', h, operand_dtype))
    rgb = torch.sigmoid(_linear(p, 'nerf.rgb', h, operand_dtype)) \
        * (1 + 2 * 0.001) - 0.001
    return torch.nn.functional.softplus(raw - 1.0), rgb


def _alpha_weights(density, lengths):
    alpha = 1.0 - torch.exp(-density * lengths)
    trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
    return trans * alpha


def render_rays(leaves: dict, origins, dirs, radii, jitters: list,
                model_cfg: dict, render_cfg: dict, operand_dtype) -> dict:
    """Colour of a block of rays and each round's (s-edges, weights),
    from one jitter (R,) per round. Float32 products stay float32: TF32
    is turned off for every matrix multiply."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rays = origins.shape[0]
    near, far = float(render_cfg['NEAR_PLANE']), float(render_cfg['FAR_PLANE'])
    sizes = [int(n) for n in render_cfg['PROPOSAL_SAMPLES']] + \
        [int(render_cfg['NERF_SAMPLES'])]
    dir_len = torch.linalg.norm(dirs, dim=-1, keepdim=True)
    edges = torch.tensor([[0.0, 1.0]], device=origins.device).expand(rays, 2)
    weights = torch.ones((rays, 1), device=origins.device)
    rounds = []
    for k, n in enumerate(sizes):
        with torch.no_grad():
            edges = _resample(edges.detach(), weights.detach(), n, jitters[k])
            t = _s_to_t(edges, near, far)
            means, covs = _frustums(origins, dirs, radii, t[:, :-1], t[:, 1:])
            means, covs = _contract(means, covs)
            feats = _ipe(means, torch.diagonal(covs, dim1=-2, dim2=-1),
                         int(model_cfg['POSITION_DEGREES'])).reshape(rays * n,
                                                                     -1)
        lengths = (t[:, 1:] - t[:, :-1]) * dir_len
        if k < len(sizes) - 1:
            density = _proposal(leaves, feats, model_cfg, operand_dtype)
            weights = _alpha_weights(density.reshape(rays, n), lengths)
            rounds.append((edges, weights))
            continue
        unit = dirs / dir_len
        density, rgb = _nerf(leaves, feats,
                             unit[:, None].expand(rays, n, 3).reshape(-1, 3),
                             model_cfg, operand_dtype)
        weights = _alpha_weights(density.reshape(rays, n), lengths)
        colour = (weights[..., None] * rgb.reshape(rays, n, 3)).sum(1)
        rounds.append((edges, weights))
    return {'rgb': colour, 'rounds': rounds}


# -- the loss ----------------------------------------------------------------

def _distortion(s, w):
    mids = (s[:, 1:] + s[:, :-1]) / 2
    inter = (w[:, :, None] * w[:, None, :] *
             (mids[:, :, None] - mids[:, None, :]).abs()).sum((1, 2))
    return inter + (w ** 2 * (s[:, 1:] - s[:, :-1])).sum(-1) / 3


def _interlevel(s, w, s_env, w_env):
    s, w = s.detach(), w.detach()
    # proposal interval j [a_j, a_j+1) overlaps NeRF interval i [c_i, c_i+1]
    # where a_j <= c_i+1 and a_j+1 > c_i
    overlap = (s_env[:, None, :-1] <= s[:, 1:, None]) & \
        (s_env[:, None, 1:] > s[:, :-1, None])
    bound = (overlap * w_env[:, None, :]).sum(-1)
    return (torch.clamp(w - bound, min=0.0) ** 2 / (w + _EPS)).sum(-1)


def block_loss(out: dict, target, train_cfg: dict, batch_rays: int):
    """A block's share of the batch's loss: its rays' sums of each term
    over the batch's ray count (the Charbonnier term's over its 3 x rays
    elements)."""
    *proposals, (s, w) = out['rounds']
    data = torch.sqrt((out['rgb'] - target) ** 2 + 1e-3 ** 2).sum() \
        / (3 * batch_rays)
    distortion = _distortion(s, w).sum() / batch_rays
    interlevel = sum(_interlevel(s, w, sp, wp).sum() / batch_rays
                     for sp, wp in proposals)
    return data + float(train_cfg['DISTORTION_LOSS_WEIGHT']) * distortion + \
        float(train_cfg['INTERLEVEL_LOSS_WEIGHT']) * interlevel


@torch.no_grad()
def clip(grads: dict, max_norm: float) -> dict:
    """The gradients scaled by min(1, max_norm / (norm + 1e-6)), norm
    their global L2 norm (``torch.nn.utils.clip_grad_norm_``'s rule)."""
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return {k: g * scale for k, g in grads.items()}
