"""3D Gaussian Splatting model: parameters, activations, densification, bake.

Port of nerficg_tpu/methods/gaussian_splatting/model.py (reference:
src/Methods/GaussianSplatting/Model.py:18-317): raw positions, SH features
(DC and rest), log-scales, quaternions and logit opacities, initialised from
a point cloud with RMS-kNN scales and opacity 0.1; clone / split / prune
densification with the optimizer's moments carried through the row edits;
opacity reset; Morton-ordered baking; the standard 3DGS PLY export.

The Gaussians live in FIXED-CAPACITY tensors with a host-side active count,
as in the JAX package: capacity grows in CAPACITY_GRANULARITY steps, and the
padding rows carry DEAD_OPACITY_RAW (sigmoid ~3e-7), under the compositor's
alpha threshold. Densification edits host numpy copies and pushes them back.
The parameters are a dict of ``nn.Parameter`` in the JAX package's tree
layout, so checkpoints swap between the packages as they are.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nerficg_torch.cameras.pose import quaternion_to_rotation_matrix
from nerficg_torch.core.config import Configurable
from nerficg_torch.core.logging import Logger
from nerficg_torch.data.types import BasicPointCloud
from nerficg_torch.methods.base.model import BaseModel
from nerficg_torch.methods.gaussian_splatting.convert import (
    PARAM_KEYS, params_from_numpy, params_to_numpy)
from nerficg_torch.ops.encoding import SH_C0
from nerficg_torch.ops.gaussian import activate_opacities
from nerficg_torch.ops.knn import knn_mean_sq_distance
from nerficg_torch.ops.morton import morton_encode_positions
from nerficg_torch.optim.state_surgery import apply_row_surgery

__all__ = ['GaussianSplattingModel', 'DEAD_OPACITY_RAW']

DEAD_OPACITY_RAW = -15.0    # sigmoid ~ 3e-7: under the alpha threshold


def _inverse_sigmoid(x):
    return np.log(x / (1.0 - x))


@Configurable.configure(
    SH_DEGREE=4,                 # bands; 16 coefficients
    INITIAL_OPACITY=0.1,
    CAPACITY_GRANULARITY=16384,  # tensors grow in these increments
    MAX_CAPACITY=4194304,
)
class GaussianSplattingModel(BaseModel):

    params: dict[str, torch.nn.Parameter]

    def build(self, generator: Optional[torch.Generator] = None
              ) -> 'GaussianSplattingModel':
        """A placeholder cloud; trainers re-initialise from the dataset
        (reference: Trainer.py:62-68)."""
        rng = np.random.default_rng(0)
        self.init_from_point_cloud(BasicPointCloud(
            positions=rng.random((1024, 3)).astype(np.float32) * 2 - 1,
            colors=rng.random((1024, 3)).astype(np.float32)))
        return self

    def _set_params(self, params: dict) -> None:
        """Parameters from ``nn.Parameter``s or host arrays."""
        if not all(isinstance(p, torch.nn.Parameter)
                   for p in params.values()):
            params = params_from_numpy(params, self.device)
        self.params = dict(params)
        self.module = torch.nn.ParameterDict(self.params)

    # -- initialization ------------------------------------------------------
    def init_from_point_cloud(self, pcd: BasicPointCloud) -> None:
        """(reference: Model.py:94-119)"""
        n = len(pcd)
        positions = np.asarray(pcd.positions, np.float32)
        colors = pcd.colors if pcd.colors is not None else \
            np.full((n, 3), 0.5)
        mean_sq = np.maximum(knn_mean_sq_distance(positions, 3), 1e-7)
        scales = np.log(np.sqrt(mean_sq))[:, None].repeat(3, axis=1)
        rotations = np.zeros((n, 4), np.float32)
        rotations[:, 0] = 1.0
        opacities = np.full((n, 1),
                            _inverse_sigmoid(float(self.INITIAL_OPACITY)),
                            np.float32)
        num_coeffs = int(self.SH_DEGREE) ** 2
        features_dc = ((colors - 0.5) / SH_C0).astype(np.float32)[:, None, :]
        features_rest = np.zeros((n, num_coeffs - 1, 3), np.float32)
        capacity = self._capacity_for(n)
        self._set_params({
            'positions': self._padded(positions, capacity),
            'features_dc': self._padded(features_dc, capacity),
            'features_rest': self._padded(features_rest, capacity),
            'scales': self._padded(scales.astype(np.float32), capacity,
                                   fill=-10.0),
            'rotations': self._padded(rotations, capacity),
            'opacities': self._padded(opacities, capacity,
                                      fill=DEAD_OPACITY_RAW)})
        self.num_active = n
        self.buffers = {}
        self.active_sh_degree = 1

    def _capacity_for(self, n: int) -> int:
        gran = int(self.CAPACITY_GRANULARITY)
        return min(max(-(-n // gran), 1) * gran, int(self.MAX_CAPACITY))

    @staticmethod
    def _padded(arr: np.ndarray, capacity: int,
                fill: float = 0.0) -> np.ndarray:
        pad = capacity - arr.shape[0]
        if pad > 0:
            arr = np.concatenate(
                [arr, np.full((pad,) + arr.shape[1:], fill, arr.dtype)])
        return arr

    @property
    def capacity(self) -> int:
        return int(self.params['positions'].shape[0])

    # -- checkpoints -----------------------------------------------------------
    def params_tree(self) -> dict:
        return params_to_numpy(self.params)

    def load_params_tree(self, tree: dict) -> None:
        self._set_params(params_from_numpy(tree, self.device))

    def save(self, path) -> None:
        """With the active count and SH degree as buffers (JAX :282-287)."""
        self.buffers = dict(self.buffers)
        self.buffers['num_active'] = torch.tensor(self.num_active,
                                                  dtype=torch.int32)
        self.buffers['active_sh_degree'] = torch.tensor(
            self.active_sh_degree, dtype=torch.int32)
        super().save(path)

    @classmethod
    def load(cls, path, config=None, device='cuda') -> 'GaussianSplattingModel':
        model = super().load(path, config, device=device)
        buffers = model.buffers
        model.num_active = int(buffers['num_active']) \
            if 'num_active' in buffers else model.capacity
        model.active_sh_degree = int(buffers['active_sh_degree']) \
            if 'active_sh_degree' in buffers else int(model.SH_DEGREE)
        return model

    def get_ply_dict(self) -> dict:
        """The active Gaussians in the standard 3DGS PLY vertex layout
        (reference: Model.py:286-317; nerficg_tpu :260-280): the raw
        parameters, the SH rest coefficients channel-major."""
        n = self.num_active
        host = {k: v[:n] for k, v in self.params_tree().items()}
        out = {
            'x': host['positions'][:, 0], 'y': host['positions'][:, 1],
            'z': host['positions'][:, 2],
            'nx': np.zeros(n, np.float32), 'ny': np.zeros(n, np.float32),
            'nz': np.zeros(n, np.float32),
        }
        for i in range(3):
            out[f'f_dc_{i}'] = host['features_dc'][:, 0, i]
        rest = host['features_rest'].transpose(0, 2, 1).reshape(n, -1)
        for i in range(rest.shape[1]):
            out[f'f_rest_{i}'] = rest[:, i]
        out['opacity'] = host['opacities'][:, 0]
        for i in range(3):
            out[f'scale_{i}'] = host['scales'][:, i]
        for i in range(4):
            out[f'rot_{i}'] = host['rotations'][:, i]
        return out

    # -- activations -----------------------------------------------------------
    @staticmethod
    def get_opacities(params) -> torch.Tensor:
        return activate_opacities(params['opacities'])

    # -- densification (host side; reference: Model.py:202-259) -------------
    def densify_and_prune(self, optimizer: torch.optim.Optimizer,
                          grad_accum: np.ndarray, grad_count: np.ndarray,
                          grad_threshold: float, scene_extent: float,
                          percent_dense: float = 0.01,
                          min_opacity: float = 0.005,
                          max_screen_size: Optional[float] = None,
                          max_radii: Optional[np.ndarray] = None) -> None:
        """Clone small / split large / prune, as the JAX model does
        (nerficg_tpu :133-227); ``optimizer``'s moments follow the rows."""
        n_active = self.num_active
        capacity = self.capacity
        host = self.params_tree()
        avg_grad = grad_accum / np.maximum(grad_count, 1)
        scales = np.exp(host['scales'])
        max_scale = scales.max(-1)
        opacity = 1.0 / (1.0 + np.exp(-host['opacities'][:, 0]))

        active = np.zeros(capacity, bool)
        active[:n_active] = True
        needs_densify = active & (avg_grad >= grad_threshold)
        small = max_scale <= percent_dense * scene_extent
        to_clone = needs_densify & small
        to_split = needs_densify & ~small
        to_prune = active & (opacity < min_opacity)
        if max_screen_size is not None and max_radii is not None:
            to_prune |= active & (max_radii > max_screen_size)
            to_prune |= active & (max_scale > 0.1 * scene_extent)
        keep = active & ~to_prune

        keep_idx = np.nonzero(keep)[0]
        clone_idx = np.nonzero(to_clone & keep)[0]
        split_idx = np.nonzero(to_split & keep)[0]
        # A split parent becomes two children: its row, moved, and a new one.
        new_total = len(keep_idx) + len(clone_idx) + len(split_idx)
        new_capacity = self._capacity_for(new_total)

        rng = np.random.default_rng(int(n_active))
        split_scales = scales[split_idx]
        offsets = rng.normal(size=(len(split_idx), 3)).astype(np.float32) * \
            split_scales
        rots = quaternion_to_rotation_matrix(host['rotations'][split_idx])
        world_offsets = np.einsum('nij,nj->ni', rots,
                                  offsets).astype(np.float32)

        def surgery(arr: np.ndarray) -> np.ndarray:
            out = np.concatenate([arr[keep_idx], arr[clone_idx],
                                  arr[split_idx]], axis=0)
            pad = new_capacity - out.shape[0]
            if pad > 0:
                out = np.concatenate(
                    [out, np.zeros((pad,) + out.shape[1:], arr.dtype)])
            return out

        new = {key: surgery(arr) for key, arr in host.items()}
        # Padding rows must stay invisible (zero-padded opacity would be
        # sigmoid(0) = 0.5: ghost splats at the origin).
        new['opacities'][new_total:] = DEAD_OPACITY_RAW
        base = len(keep_idx) + len(clone_idx)
        if len(split_idx):
            sl = slice(base, base + len(split_idx))
            new['positions'][sl] = host['positions'][split_idx] + \
                world_offsets
            new['scales'][sl] = np.log(np.maximum(split_scales / 1.6, 1e-7))
            # The parents' own rows (in the kept block) shrink and move too.
            parent_pos = np.searchsorted(keep_idx, split_idx)
            offsets2 = rng.normal(size=(len(split_idx), 3)).astype(
                np.float32) * split_scales
            world_offsets2 = np.einsum('nij,nj->ni', rots, offsets2)
            new['positions'][parent_pos] = host['positions'][split_idx] + \
                world_offsets2.astype(np.float32)
            new['scales'][parent_pos] = np.log(
                np.maximum(split_scales / 1.6, 1e-7))

        params = apply_row_surgery(self.params, optimizer, surgery)
        with torch.no_grad():
            for key in ('positions', 'scales', 'opacities'):
                params[key].copy_(torch.as_tensor(new[key]))
        self._set_params(params)
        self.num_active = new_total
        Logger.verbose(f'densify: {n_active} -> {new_total} gaussians '
                       f'(+{len(clone_idx)} clone, +{len(split_idx)} split, '
                       f'-{int(to_prune.sum())} pruned)')

    def reset_opacity(self) -> None:
        """Clamp every opacity to <= 0.01 (reference: Model.py:152-155)."""
        raw_cap = float(_inverse_sigmoid(0.01))
        with torch.no_grad():
            self.params['opacities'].clamp_(max=raw_cap)

    # -- baking ----------------------------------------------------------------
    def bake(self) -> None:
        """Morton-order the active Gaussians over their own bounds and prune
        invisible ones (reference: Model.py:261-284); the raw
        parameterisation stays."""
        host = self.params_tree()
        n = self.num_active
        opacity = 1.0 / (1.0 + np.exp(-host['opacities'][:n, 0]))
        keep = np.nonzero(opacity >= 1.0 / 255.0)[0]
        if len(keep) == 0:
            Logger.warning('bake: no visible gaussians; keeping all')
            keep = np.arange(n)
        pos = host['positions'][keep]
        codes = morton_encode_positions(
            torch.as_tensor(pos), torch.as_tensor(pos.min(0)),
            torch.as_tensor(pos.max(0)))
        # np.argsort on the JAX package's uint32 codes: the same sort, so
        # equal codes keep the same order.
        order = keep[np.argsort(codes.numpy().astype(np.uint32))]
        capacity = self._capacity_for(len(order))
        self._set_params({
            key: self._padded(arr[order], capacity,
                              DEAD_OPACITY_RAW if key == 'opacities' else 0.0)
            for key, arr in host.items()})
        self.num_active = len(order)
