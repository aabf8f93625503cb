"""Framework exception taxonomy.

Port of nerficg_tpu/core/errors.py (reference: src/Framework.py:360-428):
a typed hierarchy whose members log through ``Logger.error`` when raised,
and ``catch``, which keeps a callback's failure from ending a run.
"""

from __future__ import annotations

import functools
import traceback
from typing import Callable

from nerficg_torch.core.logging import Logger

__all__ = [
    'FrameworkError', 'ConfigError', 'CheckpointError', 'DatasetError',
    'CameraError', 'ModelError', 'RendererError', 'TrainerError',
    'SamplerError', 'MethodError',
    'VisualizationError', 'KernelError', 'GuiError', 'ShardingError',
    'catch',
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


class SamplerError(FrameworkError):
    """Ray/view sampler failure."""


class MethodError(FrameworkError):
    """Unknown method or broken method plugin."""


class VisualizationError(FrameworkError):
    """Colormap failure."""


class KernelError(FrameworkError):
    """CUDA kernel build, argument or launch failure."""


class GuiError(FrameworkError):
    """Viewer process or shared-state failure."""


class ShardingError(FrameworkError):
    """Process-group, device-mesh or batch-layout failure."""


# Every traceback ``catch`` has logged in this process, so that a callback
# failing on every call logs once (and a caller can see what was caught).
_seen_tracebacks: set[str] = set()


def catch(cleanup: Callable | None = None):
    """Decorator: swallow and log exceptions, deduplicated by traceback
    (reference: ``Framework.catch``, src/Framework.py:327-356), so that the
    viewer's callbacks cannot kill a training run."""

    def decorator(fn: Callable):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            try:
                return fn(*args, **kwargs)
            except Exception:
                tb = traceback.format_exc()
                if tb not in _seen_tracebacks:
                    _seen_tracebacks.add(tb)
                    Logger.error(f'caught exception in {fn.__qualname__}:\n'
                                 f'{tb}')
                if cleanup is not None:
                    cleanup(*args, **kwargs)
                return None
        return wrapper

    return decorator
