"""Adam-state surgery: carry ``torch.optim.Adam``'s moments through row
edits of the parameters they belong to.

Port of nerficg_tpu/optim/state_surgery.py (reference:
src/Optim/adam_utils.py:6-103), the backbone of 3DGS densification: a row
transform (select, concatenate, pad) applied to a parameter is applied to its
``exp_avg`` and ``exp_avg_sq`` too, its ``step`` carries over, and the
optimizer's parameter groups point at the new tensors. Surgery runs on host
numpy between steps, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ['apply_row_surgery', 'reset_rows']


def apply_row_surgery(params: dict[str, torch.Tensor],
                      optimizer: torch.optim.Optimizer,
                      fn: Callable[[np.ndarray], np.ndarray]
                      ) -> dict[str, torch.nn.Parameter]:
    """New parameters ``fn(row array)`` for every entry of ``params``; the
    optimizer moves each parameter's moments through ``fn`` and keeps its
    step (nerficg_tpu :41-62). A parameter that has not been stepped yet
    has no moments to move."""
    new_params = {}
    replaced = {}
    for key, p in params.items():
        new_p = torch.nn.Parameter(torch.as_tensor(
            fn(p.detach().cpu().numpy()), device=p.device))
        new_params[key] = new_p
        replaced[p] = new_p
        state = optimizer.state.pop(p, None)
        if state:
            optimizer.state[new_p] = {
                'step': state['step'],
                **{name: torch.as_tensor(
                    fn(state[name].detach().cpu().numpy()), device=p.device)
                   for name in ('exp_avg', 'exp_avg_sq')}}
    for group in optimizer.param_groups:
        group['params'] = [replaced.get(p, p) for p in group['params']]
    return new_params


def reset_rows(optimizer: torch.optim.Optimizer, param: torch.Tensor,
               row_mask: np.ndarray) -> None:
    """Zero ``param``'s Adam moments in the selected rows, in place (after
    an opacity reset; nerficg_tpu :62, reference: adam_utils.py:64-80)."""
    state = optimizer.state[param]
    mask = torch.as_tensor(np.asarray(row_mask, bool), device=param.device)
    for name in ('exp_avg', 'exp_avg_sq'):
        state[name][mask] = 0.0
