"""Ray sample generation, stratified and hierarchical (inverse CDF), the
port of nerficg_tpu/ops/sampling.py (reference: NeRF/utils.py:57-110),
and Mip-NeRF 360's resampling of intervals in normalised s-space
(``s_to_t``, ``sample_intervals``). Batched over rays in plain PyTorch, no
kernel.

Uniform draws come from an explicit ``torch.Generator`` on the rays'
device, or the caller hands them in as ``u`` (the tests pass JAX's draws).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ['stratified_samples', 'sample_pdf', 'merge_sorted_samples',
           's_to_t', 'sample_intervals']


def _uniform(generator: Optional[torch.Generator], shape: tuple,
             device: torch.device) -> torch.Tensor:
    if generator is None:
        raise ValueError('randomized sampling needs a generator or u')
    return torch.rand(shape, generator=generator, device=device)


def stratified_samples(generator: Optional[torch.Generator], num_rays: int,
                       num_samples: int, near: torch.Tensor | float,
                       far: torch.Tensor | float, randomized: bool = True,
                       u: Optional[torch.Tensor] = None,
                       device: torch.device | str = 'cpu') -> torch.Tensor:
    """Stratified depths in [near, far] -> (num_rays, num_samples): one
    sample per equal bin, at ``u`` within it (U(0, 1) when randomized, else
    the midpoint 0.5)."""
    device = torch.device(device)
    bins = torch.linspace(0.0, 1.0, num_samples + 1, device=device)
    lower, upper = bins[:-1], bins[1:]
    if u is None:
        u = _uniform(generator, (num_rays, num_samples), device) \
            if randomized else torch.full((num_rays, num_samples), 0.5,
                                          device=device)
    t = lower[None, :] + (upper - lower)[None, :] * u
    near = torch.as_tensor(near, dtype=torch.float32, device=device
                           ).expand(num_rays)[:, None]
    far = torch.as_tensor(far, dtype=torch.float32, device=device
                          ).expand(num_rays)[:, None]
    return near + (far - near) * t


def sample_pdf(generator: Optional[torch.Generator], bins: torch.Tensor,
               weights: torch.Tensor, num_samples: int,
               randomized: bool = True, eps: float = 1e-5,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF sampling of new depths from per-segment weights.

    bins: (R, S+1) ascending segment boundaries; weights: (R, S)
    non-negative. Returns (R, num_samples). Deterministic draws sit at
    linspace(eps, 1 - eps); a draw equal to a CDF value takes the bin to
    its right (``searchsorted(side='right')``)."""
    weights = weights + eps
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)   # (R, S+1)
    num_rays = bins.shape[0]
    if u is None:
        if randomized:
            u = _uniform(generator, (num_rays, num_samples), bins.device)
        else:
            u = torch.linspace(eps, 1.0 - eps, num_samples,
                               device=bins.device).expand(num_rays,
                                                          num_samples)
    u = u.contiguous()
    idx = torch.searchsorted(cdf.contiguous(), u, right=True)
    last = cdf.shape[-1] - 1
    below = torch.clamp(idx - 1, 0, last)
    above = torch.clamp(idx, 0, last)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bin_last = bins.shape[-1] - 1
    bins_below = torch.gather(bins, -1, torch.clamp(below, 0, bin_last))
    bins_above = torch.gather(bins, -1, torch.clamp(above, 0, bin_last))
    span = cdf_above - cdf_below
    denom = torch.where(span < eps, 1.0, span)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def merge_sorted_samples(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Both per-ray sample sets, sorted ascending (the coarse + fine merge,
    reference: NeRF/Renderer.py:60-70)."""
    return torch.sort(torch.cat([a, b], -1), -1).values


def s_to_t(s: torch.Tensor, near: float, far: float) -> torch.Tensor:
    """Distances of normalised s in [0, 1] under g(x) = 1/x:
    s = (g(t) - g(near)) / (g(far) - g(near)), so
    t = 1 / (s / far + (1 - s) / near)."""
    return 1.0 / (s / far + (1.0 - s) / near)


def sample_intervals(generator: Optional[torch.Generator],
                     edges: torch.Tensor, weights: torch.Tensor,
                     num_samples: int, randomized: bool = True,
                     u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """New intervals from a piecewise-constant histogram: ``edges``
    (R, M+1) ascending in [0, 1], ``weights`` (R, M) non-negative ->
    (R, num_samples + 1) edges, detached.

    ``num_samples`` centres at the stratified quantiles (i + j) / n of
    the normalised histogram, one jitter j ~ U(0, 1) per ray (``u``, (R,),
    or drawn from ``generator``; 0.5 when not randomized), by the inverse
    of its piecewise-linear CDF; the new edges lie at the midpoints
    between neighbouring centres, the outer two mirrored about the outer
    centres and clamped to [0, 1]."""
    edges, weights = edges.detach(), weights.detach()
    num_rays = edges.shape[0]
    if u is None:
        u = _uniform(generator, (num_rays,), edges.device) if randomized \
            else torch.full((num_rays,), 0.5, device=edges.device)
    steps = torch.arange(num_samples, dtype=torch.float32,
                         device=edges.device)
    q = (steps[None, :] + u[:, None]) / num_samples                # (R, n)
    pdf = weights / torch.clamp(weights.sum(-1, keepdim=True),
                                min=torch.finfo(torch.float32).tiny)
    cdf = torch.clamp(torch.cumsum(pdf[:, :-1], -1), max=1.0)
    end = torch.ones_like(pdf[:, :1])
    cdf = torch.cat([torch.zeros_like(end), cdf, end], -1)         # (R, M+1)
    last = cdf.shape[-1] - 1
    idx = torch.clamp(torch.searchsorted(cdf.contiguous(), q.contiguous(),
                                         right=True), 1, last)
    cdf_lo = torch.gather(cdf, -1, idx - 1)
    cdf_hi = torch.gather(cdf, -1, idx)
    s_lo = torch.gather(edges, -1, idx - 1)
    s_hi = torch.gather(edges, -1, idx)
    span = cdf_hi - cdf_lo
    frac = torch.clamp((q - cdf_lo) / torch.where(span > 0, span, 1.0),
                       0.0, 1.0)
    centres = s_lo + frac * (s_hi - s_lo)
    mids = 0.5 * (centres[:, 1:] + centres[:, :-1])
    first = torch.clamp(2.0 * centres[:, :1] - mids[:, :1], min=0.0)
    last_edge = torch.clamp(2.0 * centres[:, -1:] - mids[:, -1:], max=1.0)
    return torch.cat([first, mids, last_edge], -1)
