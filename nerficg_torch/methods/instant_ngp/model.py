"""Instant-NGP model: hash-grid encode + small MLPs + occupancy grid.

Port of nerficg_tpu/methods/instant_ngp/model.py (reference:
src/Methods/InstantNGP/Model.py:31-123): a 16-level hash grid (2 features,
2^14 entries per level by default, base 16 -> 2048), a 1x64 density MLP
producing [sigma, 15 features], SH degree-4 directions with a 2x64 color
MLP -> sigmoid RGB, and 128^3 occupancy grids per cascade.

ENCODING_BACKEND picks the encode of the (L, 2, R, 128) table, as the JAX
model does (:206-257): 'window' (vertex-shared corners, windowed over the
morton-sorted stream; ops/hash_window.py), 'cell' (cell-packed corners, one
window address per sample, always exact; ops/hash_cell.py) or 'xbar' (the
full-table encode on the ray-ordered stream; ops/hash_xbar.py). The first
two are feature-major and feed ``_mlp_featT``; 'xbar' is sample-major.

The MLPs multiply as the JAX package does: operands rounded to bf16,
products accumulated in f32 (``jnp.dot(bf16, bf16, preferred_element_type=
f32)``). Here the rounded operands are cast back to f32 and multiplied in
f32 (``torch.matmul`` on bf16 would return bf16), with TF32 off.

Training evaluates the encode with STOCHASTIC_CORNERS sampled corners per
(sample, level) when given an encode seed (the TPU's default training path),
or exactly with STOCHASTIC_CORNERS=0; rendering is always exact. The cell
encode is always exact and ignores the seed.

A model class with ``NEEDS_POS_GRAD`` (D-NeRF's deformation field) needs
d(encode)/d(position): only the crossbar has it (``hash_encode_xbar_posgrad``
and its stochastic form), and the other backends refuse to build.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from nerficg_torch.core.config import Configurable
from nerficg_torch.core.errors import ModelError
from nerficg_torch.methods.base.model import BaseModel
from nerficg_torch.methods.instant_ngp.convert import (params_from_numpy,
                                                       params_to_numpy)
from nerficg_torch.ops.encoding import sh_encode
from nerficg_torch.ops.hash_cell import hash_encode_cell
from nerficg_torch.ops.hash_window import (hash_encode_win,
                                           hash_encode_win_stochastic)
from nerficg_torch.ops.hash_xbar import (
    hash_encode_xbar, hash_encode_xbar_posgrad, hash_encode_xbar_stochastic,
    hash_encode_xbar_stochastic_posgrad)
from nerficg_torch.ops.hashgrid import HashGridConfig, init_hash_grid_mxu
from nerficg_torch.ops.occupancy import num_cascades

__all__ = ['InstantNGPModel', 'InstantNGPField', 'trunc_exp',
           'ENCODING_BACKENDS']

ENCODING_BACKENDS = ('window', 'cell', 'xbar')


class _TruncExp(torch.autograd.Function):
    """y = exp(clamp(x, -15, 15)) with dy/dx = y everywhere: the JAX
    ``custom_jvp`` (nerficg_tpu/methods/instant_ngp/model.py:35-45). Autograd
    of ``clamp`` would zero the gradient outside [-15, 15]."""

    @staticmethod
    def forward(ctx, x):
        y = torch.exp(torch.clamp(x, -15.0, 15.0))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp with its argument clamped to [-15, 15] and its gradient not
    (Instant-NGP 'TruncExp')."""
    return _TruncExp.apply(x)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _mlp(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    """ReLU MLP of bias-free linear layers (last layer linear), bf16
    operands with f32 accumulation."""
    for i, layer in enumerate(layers):
        x = _bf16(x) @ _bf16(layer.weight).T
        if i + 1 < len(layers):
            x = torch.relu(x)
    return x


def _mlp_featT(layers: nn.ModuleList, x_t: torch.Tensor) -> torch.Tensor:
    """_mlp whose input arrives feature-major (F, N), the encode's layout."""
    x = _bf16(x_t).T @ _bf16(layers[0].weight).T
    if len(layers) == 1:
        return x
    return _mlp(layers[1:], torch.relu(x))


class InstantNGPField(nn.Module):
    """Parameters and field evaluation on unit-cube positions."""

    def __init__(self, hash_config: HashGridConfig, density_width: int,
                 geo_features: int, color_width: int, sh_degree: int,
                 backend: str = 'window', pos_grad: bool = False):
        super().__init__()
        self.hash_config = hash_config
        self.backend = backend
        self.pos_grad = pos_grad
        self.sh_degree = sh_degree
        c = hash_config
        self.hash_table = nn.Parameter(torch.zeros(
            c.num_levels, c.features_per_level, c.table_size // 128, 128))
        self.density_mlp = nn.ModuleList([
            nn.Linear(c.output_dim, density_width, bias=False),
            nn.Linear(density_width, 1 + geo_features, bias=False)])
        self.color_mlp = nn.ModuleList([
            nn.Linear(sh_degree ** 2 + geo_features, color_width, bias=False),
            nn.Linear(color_width, color_width, bias=False),
            nn.Linear(color_width, 3, bias=False)])

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """tcnn-style init: table U(-1e-4, 1e-4), He-uniform MLPs."""
        with torch.no_grad():
            self.hash_table.copy_(init_hash_grid_mxu(self.hash_config,
                                                     generator))
            for layer in [*self.density_mlp, *self.color_mlp]:
                bound = float(np.sqrt(6.0 / layer.in_features))
                w = torch.rand(layer.weight.shape, generator=generator)
                layer.weight.copy_(w * (2 * bound) - bound)

    def density(self, unit: torch.Tensor,
                anchor_keys: Optional[torch.Tensor] = None,
                encode_seed: Optional[int] = None, n_corners: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """unit positions (N, 3) -> (density (N,), geo features (N, GEO)).
        With an ``encode_seed`` and ``n_corners`` > 0 the window and
        crossbar encodes sample that many corners per (sample, level)."""
        table, config = self.hash_table, self.hash_config
        stochastic = encode_seed is not None and n_corners > 0
        if self.backend == 'cell':
            h = _mlp_featT(self.density_mlp,
                           hash_encode_cell(table, unit, config, anchor_keys))
        elif self.backend == 'window':
            if stochastic:
                feats_t = hash_encode_win_stochastic(
                    table, unit, encode_seed, config, n_corners, anchor_keys)
            else:
                feats_t = hash_encode_win(table, unit, config, anchor_keys)
            h = _mlp_featT(self.density_mlp, feats_t)
        elif stochastic:
            encode = hash_encode_xbar_stochastic_posgrad if self.pos_grad \
                else hash_encode_xbar_stochastic
            h = _mlp(self.density_mlp,
                     encode(table, unit, encode_seed, config, n_corners))
        else:
            encode = hash_encode_xbar_posgrad if self.pos_grad \
                else hash_encode_xbar
            h = _mlp(self.density_mlp, encode(table, unit, config))
        return trunc_exp(h[:, 0]), h[:, 1:]

    def color(self, geo: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
        """(N, GEO) features + (N, 3) unit dirs -> (N, 3) rgb."""
        x = torch.cat([sh_encode(directions, self.sh_degree), geo], dim=-1)
        return torch.sigmoid(_mlp(self.color_mlp, x))

    def forward(self, unit: torch.Tensor, directions: torch.Tensor,
                anchor_keys: Optional[torch.Tensor] = None,
                encode_seed: Optional[int] = None, n_corners: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor]:
        sigma, geo = self.density(unit, anchor_keys, encode_seed, n_corners)
        return sigma, self.color(geo, directions)


@Configurable.configure(
    NUM_LEVELS=16,
    FEATURES_PER_LEVEL=2,
    LOG2_HASHMAP_SIZE=14,
    ENCODING_BACKEND='window',
    STOCHASTIC_CORNERS=4,       # training only: rendering is exact 8-corner
    ENCODE_ANCHOR_STRIDE=8,     # must match RENDERER.MARCH_BLOCK
    BASE_RESOLUTION=16,
    TARGET_RESOLUTION=2048,
    DENSITY_MLP_WIDTH=64,
    DENSITY_MLP_LAYERS=1,
    GEO_FEATURES=15,
    COLOR_MLP_WIDTH=64,
    COLOR_MLP_LAYERS=2,
    SH_DEGREE=4,
    GRID_RESOLUTION=128,
    SCALE=0.5,                  # half-extent of the scene box around center
    CENTER=[0.0, 0.0, 0.0],
)
class InstantNGPModel(BaseModel):

    # Dynamic methods (deformation fields) set this so that the encode's
    # backward also gives the position gradient (ops/hash_xbar.py).
    NEEDS_POS_GRAD = False

    def build(self, generator: Optional[torch.Generator] = None
              ) -> 'InstantNGPModel':
        backend = str(self.ENCODING_BACKEND)
        if backend not in ENCODING_BACKENDS:
            raise ModelError(f'unknown ENCODING_BACKEND {backend!r}; one of '
                             f'{ENCODING_BACKENDS}')
        if self.NEEDS_POS_GRAD and backend != 'xbar':
            raise ValueError(
                f'ENCODING_BACKEND={backend} has no position-gradient kernel; '
                "deformation methods must set ENCODING_BACKEND='xbar'")
        # The windowed encodes take their windows over one anchor per
        # march block; the crossbar runs on the ray-ordered stream.
        self.hash_config = HashGridConfig(
            num_levels=int(self.NUM_LEVELS),
            features_per_level=int(self.FEATURES_PER_LEVEL),
            log2_table_size=int(self.LOG2_HASHMAP_SIZE),
            base_resolution=int(self.BASE_RESOLUTION),
            target_resolution=int(self.TARGET_RESOLUTION),
            anchor_stride=int(self.ENCODE_ANCHOR_STRIDE)
            if backend in ('window', 'cell') else 1)
        field = InstantNGPField(self.hash_config,
                                int(self.DENSITY_MLP_WIDTH),
                                int(self.GEO_FEATURES),
                                int(self.COLOR_MLP_WIDTH),
                                int(self.SH_DEGREE), backend,
                                self.NEEDS_POS_GRAD)
        field.reset_parameters(generator)
        self.module = field.to(self.device)
        # Cascade c covers the box of half-extent SCALE * 2^(c - (C-1))
        # (reference: InstantNGP/Model.py:53-57).
        self.cascades = num_cascades(float(self.SCALE))
        resolution = int(self.GRID_RESOLUTION)
        self.buffers = {'density_grid': torch.zeros(
            self.cascades * resolution ** 3, device=self.device)}
        center = np.asarray(self.CENTER, np.float32)
        scale = float(self.SCALE)
        self.center = torch.as_tensor(center, device=self.device)
        self.aabb_min = torch.as_tensor(center - scale, device=self.device)
        self.aabb_max = torch.as_tensor(center + scale, device=self.device)
        return self

    def params_tree(self) -> dict:
        return params_to_numpy(self.module.state_dict())

    def load_params_tree(self, tree: dict) -> None:
        self.module.load_state_dict(params_from_numpy(tree))

    def _unit(self, positions: torch.Tensor) -> torch.Tensor:
        unit = (positions - self.aabb_min) / (self.aabb_max - self.aabb_min)
        return torch.clamp(unit, 0.0, 1.0 - 1e-6)

    def density(self, positions: torch.Tensor,
                encode_seed: Optional[int] = None,
                anchor_keys: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """World positions (N, 3) -> (density (N,), geo features). With an
        ``encode_seed`` (a uint32, training) and STOCHASTIC_CORNERS > 0 the
        window and crossbar encodes are stochastic, else exact
        (nerficg_tpu/methods/instant_ngp/model.py:192-257)."""
        return self.module.density(self._unit(positions), anchor_keys,
                                   encode_seed, int(self.STOCHASTIC_CORNERS))

    def field(self, positions: torch.Tensor, directions: torch.Tensor,
              encode_seed: Optional[int] = None,
              anchor_keys: Optional[torch.Tensor] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """World positions (N, 3) + unit dirs -> (sigma (N,), rgb (N, 3))."""
        return self.module(self._unit(positions), directions, anchor_keys,
                           encode_seed, int(self.STOCHASTIC_CORNERS))

    def mlp_weight_squares(self) -> torch.Tensor:
        """Mean of the squared MLP weights, the weight-decay term
        (nerficg_tpu/methods/instant_ngp/model.py:276-284)."""
        layers = [*self.module.density_mlp, *self.module.color_mlp]
        total = sum((layer.weight.float() ** 2).sum() for layer in layers)
        return total / max(sum(layer.weight.numel() for layer in layers), 1)
