"""Method / dataset plugin registry.

Port of nerficg_tpu/core/registry.py (reference: src/Implementations.py):
plugins register themselves when imported, and a lazy import table maps
names to the modules the port has so far.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Callable

import torch

from nerficg_torch.core.errors import DatasetError, MethodError
from nerficg_torch.core.setup import resolve_device

__all__ = ['Methods', 'Datasets', 'register_method', 'register_dataset']


@dataclass
class MethodEntry:
    name: str
    model_cls: type
    renderer_cls: type
    trainer_cls: type | None = None


_BUILTIN_METHOD_MODULES = {
    'InstantNGP': 'nerficg_torch.methods.instant_ngp',
    'GaussianSplatting': 'nerficg_torch.methods.gaussian_splatting',
    'DNeRF': 'nerficg_torch.methods.dnerf',
}
_BUILTIN_DATASET_MODULES = {
    'NeRF': 'nerficg_torch.data.loaders.nerf',
    'DNeRF': 'nerficg_torch.data.loaders.dnerf',
}

_methods: dict[str, MethodEntry] = {}
_datasets: dict[str, type] = {}


def register_method(name: str, model_cls: type, renderer_cls: type,
                    trainer_cls: type | None = None) -> None:
    _methods[name] = MethodEntry(name, model_cls, renderer_cls, trainer_cls)


def register_dataset(name: str) -> Callable[[type], type]:
    def decorator(cls: type) -> type:
        _datasets[name] = cls
        return cls
    return decorator


def _resolve_method(name: str) -> MethodEntry:
    if name not in _methods:
        module = _BUILTIN_METHOD_MODULES.get(name)
        if module is None:
            raise MethodError(
                f'unknown method {name!r} (available: '
                f'{sorted(set(_methods) | set(_BUILTIN_METHOD_MODULES))})')
        importlib.import_module(module)
    if name not in _methods:
        raise MethodError(f'method module for {name!r} did not register itself')
    return _methods[name]


def _resolve_dataset(name: str) -> type:
    if name not in _datasets:
        module = _BUILTIN_DATASET_MODULES.get(name)
        if module is None:
            raise DatasetError(
                f'unknown dataset {name!r} (available: '
                f'{sorted(set(_datasets) | set(_BUILTIN_DATASET_MODULES))})')
        importlib.import_module(module)
    if name not in _datasets:
        raise DatasetError(f'dataset module for {name!r} did not register itself')
    return _datasets[name]


class Methods:
    """Method lookup facade (reference: Implementations.Methods, :43-65).

    Models and trainers go on the first CUDA card unless the caller passes
    ``device='cpu'``; without a card they raise (``KernelError``)."""

    @staticmethod
    def get_model(config, name: str | None = None,
                  checkpoint: str | None = None,
                  device: torch.device | str = 'cuda'):
        device = resolve_device(device, "device='cpu'")
        method = config.GLOBAL.METHOD_TYPE if name is None else name
        entry = _resolve_method(method)
        if checkpoint is not None:
            return entry.model_cls.load(checkpoint, config, device=device)
        model = entry.model_cls(config, device=device)
        model.build()
        return model

    @staticmethod
    def get_renderer(config, model, name: str | None = None):
        method = config.GLOBAL.METHOD_TYPE if name is None else name
        return _resolve_method(method).renderer_cls(config, model)

    @staticmethod
    def get_training_instance(config, name: str | None = None,
                              device: torch.device | str = 'cuda'):
        """A trainer with a freshly built model and its renderer
        (reference: Implementations.Methods.get_training_instance)."""
        device = resolve_device(device, "device='cpu'")
        method = config.GLOBAL.METHOD_TYPE if name is None else name
        entry = _resolve_method(method)
        if entry.trainer_cls is None:
            raise MethodError(f'method {method!r} has no trainer in the port')
        model = Methods.get_model(config, method, device=device)
        renderer = entry.renderer_cls(config, model)
        return entry.trainer_cls(config, model, renderer)


class Datasets:
    """Dataset lookup facade (reference: Implementations.Datasets, :93)."""

    @staticmethod
    def get_dataset(config, name: str | None = None, path: str | None = None):
        dataset_type = config.GLOBAL.DATASET_TYPE if name is None else name
        cls = _resolve_dataset(dataset_type)
        return cls(config, path=path)
