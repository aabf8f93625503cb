"""Weights between the JAX package's NeRF param tree and the port's module.

The JAX tree (nerficg_tpu/methods/nerf/model.py:48-65) is
  {'fine' | 'coarse': {'trunk': [{'w', 'b'}, ...], 'density', 'feature',
                       'color_hidden', 'color_out'}}
with each layer {'w': (in, out), 'b': (out,)}. The port's ``NeRFModule``
keeps the blocks in an ``nn.ModuleDict`` of ``NeRFBlock``s of
``nn.Linear`` layers, whose weights are (out, in). Checkpoints store the
JAX tree, so the two packages read each other's files.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ['params_from_numpy', 'params_to_numpy', 'HEADS']

HEADS = ('density', 'feature', 'color_hidden', 'color_out')


def _layers(block: dict):
    """(port prefix, JAX layer dict) of each linear layer of a block."""
    for i, layer in enumerate(block['trunk']):
        yield f'trunk.{i}', layer
    for head in HEADS:
        yield head, block[head]


def params_from_numpy(tree: dict) -> dict[str, torch.Tensor]:
    """JAX param tree of numpy arrays -> the port's state dict."""
    state = {}
    for name, block in tree.items():
        for prefix, layer in _layers(block):
            state[f'{name}.{prefix}.weight'] = torch.tensor(
                np.asarray(layer['w'], np.float32)).T.contiguous()
            state[f'{name}.{prefix}.bias'] = torch.tensor(
                np.asarray(layer['b'], np.float32))
    return state


def params_to_numpy(state: dict[str, torch.Tensor]) -> dict:
    """The port's state dict -> JAX param tree of numpy arrays."""
    def layer(prefix: str) -> dict:
        w, b = (state[f'{prefix}.{k}'].detach().cpu().numpy()
                for k in ('weight', 'bias'))
        return {'w': np.ascontiguousarray(w.T), 'b': b}

    tree = {}
    for name in sorted({key.split('.')[0] for key in state}):
        depth = sum(1 for key in state if key.startswith(f'{name}.trunk.')
                    and key.endswith('.weight'))
        tree[name] = {'trunk': [layer(f'{name}.trunk.{i}')
                                for i in range(depth)],
                      **{head: layer(f'{name}.{head}') for head in HEADS}}
    return tree
