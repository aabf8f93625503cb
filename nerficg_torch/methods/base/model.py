"""Model base class: parameters on a device with checkpoint round-trip.

Port of nerficg_tpu/methods/base/model.py (reference: src/Methods/Base/
Model.py:15-111). A model is a host object holding (a) the MODEL config
section, (b) an ``nn.Module`` with the trainable parameters and (c) a dict of
non-trained buffers such as the occupancy grid, all on ``self.device``: the
first CUDA card unless the caller passes ``device='cpu'``.
Checkpoints store the parameters in the JAX package's tree layout, so the
two packages read each other's files; each method converts between that
tree and its module (``params_tree`` / ``load_params_tree``).
"""

from __future__ import annotations

import datetime
from pathlib import Path
from typing import Optional

import torch

from nerficg_torch.core.checkpoint import load_checkpoint, save_checkpoint
from nerficg_torch.core.config import ConfigNode, Configurable, recursive_update
from nerficg_torch.core.errors import ModelError
from nerficg_torch.core.setup import resolve_device

__all__ = ['BaseModel']


class BaseModel(Configurable):

    def __init__(self, config: ConfigNode | None, name: str | None = None,
                 device: torch.device | str = 'cuda'):
        super().__init__(config, 'MODEL')
        self._config = config
        self.model_name = name or (
            config.get_path('TRAINING.MODEL_NAME') if config is not None else None
        ) or type(self).__name__
        self.device = resolve_device(device, "device='cpu'")
        self.module: Optional[torch.nn.Module] = None
        self.buffers: dict[str, torch.Tensor] = {}
        self.num_iterations_trained: int = 0

    # -- plugin contract ------------------------------------------------------
    def build(self, generator: Optional[torch.Generator] = None) -> 'BaseModel':
        """Create ``self.module`` and ``self.buffers`` on ``self.device``
        (reference: Model.py:30-35)."""
        raise NotImplementedError

    def params_tree(self) -> dict:
        """Parameters as the JAX package's tree of numpy arrays."""
        raise NotImplementedError

    def load_params_tree(self, tree: dict) -> None:
        """Load parameters from the JAX package's tree of numpy arrays."""
        raise NotImplementedError

    # -- checkpointing ----------------------------------------------------------
    def save(self, path: str | Path) -> None:
        """(reference: Model.py:103-111)"""
        if self.module is None:
            raise ModelError('model not built; nothing to save')
        save_checkpoint(
            path, self.params_tree(),
            metadata={
                'method': type(self).__name__,
                'model_name': self.model_name,
                'num_iterations_trained': self.num_iterations_trained,
                'configuration': self._configuration.to_dict(),
                'saved_at': datetime.datetime.now().isoformat(),
            },
            extra_trees={'buffers': self.buffers})

    @classmethod
    def load(cls, path: str | Path, config: ConfigNode | None = None,
             device: torch.device | str = 'cuda') -> 'BaseModel':
        """Rebuild from a checkpoint; the saved MODEL configuration applies,
        overridden by ``config``'s MODEL section (reference: Model.py:60-101)."""
        payload = load_checkpoint(path)
        meta = payload['metadata']
        merged = ConfigNode({'MODEL': meta.get('configuration', {})})
        if config is not None and 'MODEL' in config:
            recursive_update(merged['MODEL'], config['MODEL'])
        model = cls(merged, name=meta.get('model_name'), device=device)
        model.build()
        model.load_params_tree(payload['params'])
        model.buffers = {
            key: torch.as_tensor(value, device=model.device)
            for key, value in payload['extra'].get('buffers', {}).items()}
        model.num_iterations_trained = int(meta.get('num_iterations_trained', 0))
        return model
