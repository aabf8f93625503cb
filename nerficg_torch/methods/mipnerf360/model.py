"""Mip-NeRF 360 model: a proposal MLP and the NeRF MLP over integrated
positional encodings of contracted conical frustums.

Barron et al., Mip-NeRF 360, CVPR 2022 (§2-§4, §6), with the released
code's defaults (google-research/multinerf, ``configs/360.gin`` and
``internal/models.py``):

* the proposal MLP: PROPOSAL_LAYERS x PROPOSAL_WIDTH ReLU layers to a
  density, no skip and no colour; one set of weights serves every
  proposal round;
* the NeRF MLP: NUM_LAYERS x WIDTH ReLU layers with the encoding
  concatenated again before layer SKIP_LAYER, a density head, a
  BOTTLENECK_WIDTH linear bottleneck concatenated with the view
  direction's ``frequency_encode`` (DIRECTION_FREQUENCIES), a VIEW_WIDTH
  ReLU layer and an RGB layer;
* densities softplus(raw - 1), colours sigmoid scaled to
  [-0.001, 1.001];
* He-uniform weights U(-sqrt(6/in), sqrt(6/in)) and zero biases.

Every linear layer multiplies as NeRF's do (``methods/nerf/model.py``
``_linear``): bf16-rounded operands, an f32 product with TF32 off, the f32
bias added. The proposal MLP runs in the ``proposal`` span and the NeRF
MLP in ``field`` (``core/tracing.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from nerficg_torch.core.config import Configurable
from nerficg_torch.core.tracing import traced
from nerficg_torch.methods.base.model import BaseModel
from nerficg_torch.methods.nerf.model import _linear
from nerficg_torch.ops.encoding import frequency_encode, \
    frequency_encoding_dim

__all__ = ['MipNeRF360Model', 'ProposalMLP', 'NeRFMLP']

DENSITY_BIAS = -1.0      # softplus(raw + DENSITY_BIAS): an empty start
RGB_PADDING = 0.001      # sigmoid colours can reach 0 and 1


def _trunk(in_dim: int, width: int, layers: int,
           skip: Optional[int]) -> nn.ModuleList:
    dims, d = [], in_dim
    for i in range(layers):
        if i == skip:
            d += in_dim
        dims.append(d)
        d = width
    return nn.ModuleList(nn.Linear(d, width) for d in dims)


def _run_trunk(trunk: nn.ModuleList, x: torch.Tensor,
               skip: Optional[int]) -> torch.Tensor:
    inputs = x
    for i, layer in enumerate(trunk):
        if i == skip:
            x = torch.cat([x, inputs], -1)
        x = torch.relu(_linear(layer, x))
    return x


class ProposalMLP(nn.Module):
    """Encoded samples -> raw density (no skip, no colour)."""

    def __init__(self, in_dim: int, width: int, layers: int):
        super().__init__()
        self.trunk = _trunk(in_dim, width, layers, None)
        self.density = nn.Linear(width, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(self.density, _run_trunk(self.trunk, x, None))[..., 0]


class NeRFMLP(nn.Module):
    """Encoded samples and encoded view directions -> (raw density, raw
    rgb)."""

    def __init__(self, in_dim: int, dir_dim: int, width: int, layers: int,
                 skip: int, bottleneck: int, view_width: int):
        super().__init__()
        self.skip = skip
        self.trunk = _trunk(in_dim, width, layers, skip)
        self.density = nn.Linear(width, 1)
        self.bottleneck = nn.Linear(width, bottleneck)
        self.view_hidden = nn.Linear(bottleneck + dir_dim, view_width)
        self.rgb = nn.Linear(view_width, 3)

    def forward(self, x: torch.Tensor, dir_enc: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        x = _run_trunk(self.trunk, x, self.skip)
        raw_density = _linear(self.density, x)[..., 0]
        h = torch.cat([_linear(self.bottleneck, x), dir_enc], -1)
        h = torch.relu(_linear(self.view_hidden, h))
        return raw_density, _linear(self.rgb, h)


@Configurable.configure(
    PROPOSAL_LAYERS=4,
    PROPOSAL_WIDTH=256,
    NUM_LAYERS=8,
    WIDTH=1024,
    SKIP_LAYER=5,
    BOTTLENECK_WIDTH=256,
    VIEW_WIDTH=128,
    POSITION_DEGREES=12,
    DIRECTION_FREQUENCIES=4,
)
class MipNeRF360Model(BaseModel):

    @property
    def encoding_dim(self) -> int:
        """Width of the integrated positional encoding: sines and cosines
        of 3 axes at POSITION_DEGREES scales."""
        return 2 * 3 * int(self.POSITION_DEGREES)

    def build(self, generator: Optional[torch.Generator] = None
              ) -> 'MipNeRF360Model':
        dir_dim = frequency_encoding_dim(3, int(self.DIRECTION_FREQUENCIES))
        module = nn.ModuleDict({
            'proposal': ProposalMLP(self.encoding_dim,
                                    int(self.PROPOSAL_WIDTH),
                                    int(self.PROPOSAL_LAYERS)),
            'nerf': NeRFMLP(self.encoding_dim, dir_dim, int(self.WIDTH),
                            int(self.NUM_LAYERS), int(self.SKIP_LAYER),
                            int(self.BOTTLENECK_WIDTH),
                            int(self.VIEW_WIDTH))})
        with torch.no_grad():
            for layer in module.modules():
                if isinstance(layer, nn.Linear):
                    bound = math.sqrt(6.0 / layer.in_features)
                    u = torch.rand(layer.weight.shape, generator=generator)
                    layer.weight.copy_(u * (2 * bound) - bound)
                    layer.bias.zero_()
        self.module = module.to(self.device)
        return self

    def params_tree(self) -> dict:
        return {k: v.detach().cpu().numpy()
                for k, v in self.module.state_dict().items()}

    def load_params_tree(self, tree: dict) -> None:
        self.module.load_state_dict({
            k: torch.as_tensor(np.asarray(v, np.float32))
            for k, v in tree.items()})

    @traced('proposal')
    def proposal_density(self, features: torch.Tensor) -> torch.Tensor:
        """(N, encoding_dim) encoded samples -> densities (N,)."""
        raw = self.module['proposal'](features)
        return nn.functional.softplus(raw + DENSITY_BIAS)

    @traced('field')
    def field(self, features: torch.Tensor, directions: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """(N, encoding_dim) encoded samples and their (N, 3) unit view
        directions -> densities (N,), rgb (N, 3)."""
        dir_enc = frequency_encode(directions,
                                   int(self.DIRECTION_FREQUENCIES))
        raw_density, raw_rgb = self.module['nerf'](features, dir_enc)
        rgb = torch.sigmoid(raw_rgb) * (1.0 + 2.0 * RGB_PADDING) - RGB_PADDING
        return nn.functional.softplus(raw_density + DENSITY_BIAS), rgb
