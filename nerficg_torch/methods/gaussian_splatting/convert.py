"""Weights between the JAX package's 3DGS parameter tree and the port's.

The JAX model (nerficg_tpu/methods/gaussian_splatting/model.py:82-91) keeps
a dict of fixed-capacity arrays
  {'positions': (C, 3), 'features_dc': (C, 1, 3), 'features_rest': (C, K-1, 3),
   'scales': (C, 3) log, 'rotations': (C, 4) wxyz, 'opacities': (C, 1) logit}
with the active count and SH degree as buffers. The port keeps the same
dict as ``nn.Parameter``s, so the conversion is a change of container.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ['PARAM_KEYS', 'params_from_numpy', 'params_to_numpy']

PARAM_KEYS = ('positions', 'features_dc', 'features_rest', 'scales',
              'rotations', 'opacities')


def params_from_numpy(tree: dict, device: torch.device | str = 'cpu'
                      ) -> dict[str, torch.nn.Parameter]:
    """JAX param tree of numpy arrays -> the port's parameters."""
    return {key: torch.nn.Parameter(torch.tensor(
        np.asarray(tree[key], np.float32), device=device))
        for key in PARAM_KEYS}


def params_to_numpy(params: dict[str, torch.Tensor]) -> dict:
    """The port's parameters -> JAX param tree of numpy arrays."""
    return {key: params[key].detach().cpu().numpy() for key in PARAM_KEYS}
