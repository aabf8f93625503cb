"""Vanilla NeRF model: frequency encodings and an 8 x 256 skip MLP per
block, a fine block and an optional coarse one.

Port of nerficg_tpu/methods/nerf/model.py (reference: src/Methods/NeRF/
Model.py:10-128): positions encoded at 10 frequencies and directions at 4,
a trunk of NUM_LAYERS x WIDTH ReLU layers with the position encoding
concatenated again before layer SKIP_LAYER, a density head (optional
pre-activation noise, then ReLU), a feature head, and feature + direction
-> WIDTH/2 -> sigmoid RGB. Weights and biases start U(-1/sqrt(in),
1/sqrt(in)), as torch.nn.Linear's defaults and the JAX ``_init_linear``.

The linear layers multiply as the JAX package does: operands rounded to
bf16, the product accumulated in f32, then the f32 bias added
(``jnp.dot(bf16, bf16, preferred_element_type=f32) + b``). Here the rounded
operands are cast back to f32 and multiplied in f32 with TF32 off
(``torch.matmul`` on bf16 would round the output to bf16). These are plain
GEMMs, outside any TPU kernel in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from nerficg_torch.core.config import Configurable
from nerficg_torch.core.tracing import traced
from nerficg_torch.methods.base.model import BaseModel
from nerficg_torch.methods.nerf.convert import params_from_numpy, \
    params_to_numpy
from nerficg_torch.ops.encoding import frequency_encode, \
    frequency_encoding_dim

__all__ = ['NeRFModel', 'NeRFBlock']


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 product, f32 bias."""
    w = layer.weight.to(torch.bfloat16).float()
    return x.to(torch.bfloat16).float() @ w.T + layer.bias


class NeRFBlock(nn.Module):
    """One NeRF MLP (reference: NeRF/Model.py:10-94)."""

    def __init__(self, num_layers: int = 8, width: int = 256,
                 skip_layer: int = 5, pos_freqs: int = 10,
                 dir_freqs: int = 4, feature_dim: Optional[int] = None):
        super().__init__()
        feature_dim = width if feature_dim is None else feature_dim
        self.skip_layer = skip_layer
        self.pos_freqs = pos_freqs
        self.dir_freqs = dir_freqs
        pos_dim = frequency_encoding_dim(3, pos_freqs)
        dir_dim = frequency_encoding_dim(3, dir_freqs)
        dims = []
        in_dim = pos_dim
        for i in range(num_layers):
            if i == skip_layer:
                in_dim += pos_dim
            dims.append(in_dim)
            in_dim = width
        self.trunk = nn.ModuleList(nn.Linear(d, width) for d in dims)
        self.density = nn.Linear(width, 1)
        self.feature = nn.Linear(width, feature_dim)
        self.color_hidden = nn.Linear(feature_dim + dir_dim, width // 2)
        self.color_out = nn.Linear(width // 2, 3)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """Weights and biases U(-1/sqrt(in), 1/sqrt(in))."""
        with torch.no_grad():
            for layer in self.modules():
                if isinstance(layer, nn.Linear):
                    bound = 1.0 / math.sqrt(layer.in_features)
                    for p in (layer.weight, layer.bias):
                        u = torch.rand(p.shape, generator=generator)
                        p.copy_(u * (2 * bound) - bound)

    def forward(self, positions: torch.Tensor, directions: torch.Tensor,
                density_noise: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """(N, 3) positions and unit directions -> (density (N,), rgb
        (N, 3)); ``density_noise`` (N,) is added before the ReLU."""
        pos_enc = frequency_encode(positions, self.pos_freqs)
        dir_enc = frequency_encode(directions, self.dir_freqs)
        x = pos_enc
        for i, layer in enumerate(self.trunk):
            if i == self.skip_layer:
                x = torch.cat([x, pos_enc], -1)
            x = torch.relu(_linear(layer, x))
        raw_density = _linear(self.density, x)[..., 0]
        if density_noise is not None:
            raw_density = raw_density + density_noise
        feature = _linear(self.feature, x)
        h = torch.relu(_linear(self.color_hidden,
                               torch.cat([feature, dir_enc], -1)))
        return torch.relu(raw_density), torch.sigmoid(
            _linear(self.color_out, h))


@Configurable.configure(
    NUM_LAYERS=8,
    WIDTH=256,
    SKIP_LAYER=5,
    POSITION_FREQUENCIES=10,
    DIRECTION_FREQUENCIES=4,
    USE_COARSE=True,
    DENSITY_NOISE_STD=0.0,
)
class NeRFModel(BaseModel):
    """A fine block and, with USE_COARSE, a coarse one (reference:
    NeRF/Model.py:97-128)."""

    def build(self, generator: Optional[torch.Generator] = None
              ) -> 'NeRFModel':
        blocks = ('coarse', 'fine') if self.USE_COARSE else ('fine',)
        module = nn.ModuleDict()
        for name in blocks:
            block = NeRFBlock(int(self.NUM_LAYERS), int(self.WIDTH),
                              int(self.SKIP_LAYER),
                              int(self.POSITION_FREQUENCIES),
                              int(self.DIRECTION_FREQUENCIES))
            block.reset_parameters(generator)
            module[name] = block
        self.module = module.to(self.device)
        return self

    def params_tree(self) -> dict:
        return params_to_numpy(self.module.state_dict())

    def load_params_tree(self, tree: dict) -> None:
        self.module.load_state_dict(params_from_numpy(tree))

    @traced('field')
    def apply(self, block: str, positions: torch.Tensor,
              directions: torch.Tensor,
              noise_generator: Optional[torch.Generator] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """Evaluate one block; with a ``noise_generator`` and
        DENSITY_NOISE_STD > 0 the raw density gets N(0, std^2) noise."""
        std = float(self.DENSITY_NOISE_STD)
        noise = None
        if noise_generator is not None and std > 0.0:
            noise = std * torch.randn(positions.shape[0],
                                      generator=noise_generator,
                                      device=positions.device)
        return self.module[block](positions, directions, noise)
