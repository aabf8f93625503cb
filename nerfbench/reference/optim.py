"""torch.optim.Adam's update written out, for the references."""

from __future__ import annotations

import math

import torch

__all__ = ['Adam']


class Adam:
    """torch.optim.Adam's update (betas 0.9, 0.999; no weight decay)
    written out, one learning rate per leaf."""

    def __init__(self, leaves: dict, eps: float,
                 betas: tuple = (0.9, 0.999)):
        self.leaves = leaves
        self.eps = eps
        self.b1, self.b2 = betas
        self.m = {n: torch.zeros_like(p, dtype=torch.float32)
                  for n, p in leaves.items()}
        self.v = {n: torch.zeros_like(p, dtype=torch.float32)
                  for n, p in leaves.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict, lrs: dict) -> None:
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for name, p in self.leaves.items():
            g = grads[name].float()
            self.m[name].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[name].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[name].sqrt() / math.sqrt(bc2)).add_(self.eps)
            update = self.m[name] / denom * (lrs[name] / bc1)
            p.sub_(update.to(p.dtype))
