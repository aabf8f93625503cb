"""D-NeRF: a time-conditioned deformation field in front of a canonical
Instant-NGP field.

Port of nerficg_tpu/methods/dnerf/model.py (the D-NeRF design, Pumarola et
al.): a bias-free ReLU MLP of the frequency-encoded position (6 frequencies)
and time (4) gives each sample an offset into the canonical frame, where the
static hash-grid field is evaluated with the crossbar encode. The MLP learns
only through d(encode)/d(position), the crossbar's position gradient
(``hash_encode_xbar_posgrad``, kernel #12), so ENCODING_BACKEND is 'xbar' and
exact corners are the default. Its output layer starts at zero, and t == 0 is
the canonical frame: ``deform`` multiplies the offset by (t != 0).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from nerficg_torch.core.config import Configurable
from nerficg_torch.methods.instant_ngp.model import InstantNGPModel, _mlp
from nerficg_torch.ops.encoding import (frequency_encode,
                                        frequency_encoding_dim)

__all__ = ['DNeRFModel']


@Configurable.configure(
    DEFORM_WIDTH=128,
    DEFORM_LAYERS=3,               # hidden layers of the deformation MLP
    DEFORM_POS_FREQUENCIES=6,
    DEFORM_TIME_FREQUENCIES=4,
    # Exact 8-corner encode: the deformation field trains through the
    # position gradient, which the stochastic estimators only approximate
    # (straight-through).
    STOCHASTIC_CORNERS=0,
    # The only encode with a position gradient.
    ENCODING_BACKEND='xbar',
)
class DNeRFModel(InstantNGPModel):

    NEEDS_POS_GRAD = True

    def build(self, generator: Optional[torch.Generator] = None
              ) -> 'DNeRFModel':
        super().build(generator)
        in_dim = frequency_encoding_dim(3, int(self.DEFORM_POS_FREQUENCIES)) \
            + frequency_encoding_dim(1, int(self.DEFORM_TIME_FREQUENCIES))
        width = int(self.DEFORM_WIDTH)
        dims = [in_dim] + [width] * int(self.DEFORM_LAYERS) + [3]
        layers = nn.ModuleList(nn.Linear(a, b, bias=False)
                               for a, b in zip(dims[:-1], dims[1:]))
        with torch.no_grad():
            # He-uniform hidden layers; a zero output layer makes the
            # deformation the identity at init.
            for layer in layers[:-1]:
                bound = float(np.sqrt(6.0 / layer.in_features))
                w = torch.rand(layer.weight.shape, generator=generator)
                layer.weight.copy_(w * (2 * bound) - bound)
            layers[-1].weight.zero_()
        self.module.deform_mlp = layers.to(self.device)
        return self

    def deform(self, positions: torch.Tensor,
               timestamps: torch.Tensor) -> torch.Tensor:
        """World positions (N, 3) at times (N,) -> canonical positions: the
        MLP's bf16 offset, gated by t != 0 (Pumarola et al., Sec. 3.1)."""
        t = timestamps.reshape(-1, 1)
        x = torch.cat([frequency_encode(positions,
                                        int(self.DEFORM_POS_FREQUENCIES)),
                       frequency_encode(t, int(self.DEFORM_TIME_FREQUENCIES))],
                      dim=-1)
        offset = _mlp(self.module.deform_mlp, x)
        return positions + offset * (t != 0.0).float()

    def density(self, positions: torch.Tensor,
                encode_seed: Optional[int] = None,
                anchor_keys: Optional[torch.Tensor] = None,
                timestamps: Optional[torch.Tensor] = None):
        """``InstantNGPModel.density`` of the deformed positions when given
        their ``timestamps``."""
        if timestamps is not None:
            positions = self.deform(positions, timestamps)
        return super().density(positions, encode_seed, anchor_keys)

    def field(self, positions: torch.Tensor, directions: torch.Tensor,
              encode_seed: Optional[int] = None,
              anchor_keys: Optional[torch.Tensor] = None,
              timestamps: Optional[torch.Tensor] = None):
        sigma, geo = self.density(positions, encode_seed, anchor_keys,
                                  timestamps)
        return sigma, self.module.color(geo, directions)
