"""Distance-based gradient scaling against near-camera floaters, ported from
nerficg_tpu/optim/gradient_scaling.py (reference:
src/Optim/gradient_scaling.py:6-27): sample gradients are scaled by the
clamped squared distance to the camera, so that near-field floaters do not
dominate early training. An identity whose backward multiplies the
gradient by the per-sample factor (JAX's ``custom_vjp``)."""

from __future__ import annotations

import torch

__all__ = ['scale_gradients_by_distance']


class _ScaleGradients(torch.autograd.Function):

    @staticmethod
    def forward(ctx, values, distances):
        ctx.save_for_backward(distances)
        return values.view_as(values)

    @staticmethod
    def backward(ctx, grad):
        distances, = ctx.saved_tensors
        factor = torch.clamp(distances * distances, 0.0, 1.0)
        if grad.ndim > distances.ndim:
            factor = factor[..., None]
        return grad * factor, None


def scale_gradients_by_distance(values: torch.Tensor,
                                distances: torch.Tensor) -> torch.Tensor:
    """``values`` unchanged; their gradient scaled by
    clamp(distances^2, 0, 1).

    values: (..., C) or (...) per-sample quantities (rgb, density).
    distances: (...) each sample's distance from the camera; no gradient
    flows to it."""
    return _ScaleGradients.apply(values, distances)
