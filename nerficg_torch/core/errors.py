"""Framework exception taxonomy.

Port of nerficg_tpu/core/errors.py (reference: src/Framework.py:360-428):
a typed hierarchy whose members log through ``Logger.error`` when raised.
"""

from __future__ import annotations

from nerficg_torch.core.logging import Logger

__all__ = [
    'FrameworkError', 'ConfigError', 'CheckpointError', 'DatasetError',
    'CameraError', 'ModelError', 'RendererError', 'TrainerError',
    'MethodError',
    'VisualizationError', 'KernelError',
]


class FrameworkError(Exception):
    """Base class; logs the message on construction (reference: Framework.py:360)."""

    def __init__(self, message: str = ''):
        super().__init__(message)
        if message:
            Logger.error(f'{type(self).__name__}: {message}')


class ConfigError(FrameworkError):
    """Invalid or missing configuration."""


class CheckpointError(FrameworkError):
    """Checkpoint save/load failure."""


class DatasetError(FrameworkError):
    """Dataset loading or validation failure."""


class CameraError(FrameworkError):
    """Camera model misuse or invalid intrinsics."""


class ModelError(FrameworkError):
    """Model construction or parameter failure."""


class RendererError(FrameworkError):
    """Renderer failure (wrong model type, invalid outputs)."""


class TrainerError(FrameworkError):
    """Training-loop failure or an option the port does not have."""


class MethodError(FrameworkError):
    """Unknown method or broken method plugin."""


class VisualizationError(FrameworkError):
    """Colormap failure."""


class KernelError(FrameworkError):
    """CUDA kernel build, argument or launch failure."""
