"""Weights between the JAX package's Instant-NGP param tree and the port's
module.

The JAX tree (nerficg_tpu/methods/instant_ngp/model.py:150-157) is
  {'hash_table': (L, 2, T/128, 128),
   'density_mlp': [W0, W1], 'color_mlp': [W0, W1, W2]}
and D-NeRF's adds 'deform_mlp': [W0, ..., W3] (nerficg_tpu/methods/dnerf/
model.py:64-70), with MLP matrices stored (in, out). The port's
``InstantNGPField`` keeps the table as it is and the MLPs as bias-free
``nn.Linear`` layers, whose weights are (out, in).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ['params_from_numpy', 'params_to_numpy']

_MLPS = ('density_mlp', 'color_mlp', 'deform_mlp')


def params_from_numpy(tree: dict) -> dict[str, torch.Tensor]:
    """JAX param tree of numpy arrays -> the port's state dict."""
    state = {'hash_table': torch.tensor(np.asarray(tree['hash_table'],
                                                   np.float32))}
    for name in _MLPS:
        for i, w in enumerate(tree.get(name, ())):
            state[f'{name}.{i}.weight'] = torch.tensor(
                np.asarray(w, np.float32)).T.contiguous()
    return state


def params_to_numpy(state: dict[str, torch.Tensor]) -> dict:
    """The port's state dict -> JAX param tree of numpy arrays."""
    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    tree = {'hash_table': host(state['hash_table'])}
    for name in _MLPS:
        count = sum(1 for key in state if key.startswith(f'{name}.'))
        if count:
            tree[name] = [np.ascontiguousarray(
                host(state[f'{name}.{i}.weight']).T) for i in range(count)]
    return tree
