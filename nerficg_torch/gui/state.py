"""Shared state between the training (or checkpoint) process and the viewer.

Port of nerficg_tpu/gui/state.py (reference: the ICGui ``SharedState``
channel, SURVEY §2.15; fields read at src/Methods/Base/GuiTrainer.py:90-199):
configurable_advertisements, configurable_changes, view, gt_index, gt_split,
screenshot_view, terminate_training, is_training, training_iteration, frame.

Built over a ``multiprocessing`` Manager dict, so any viewer (the built-in
web viewer or another frontend) can attach. Frames cross as float32 numpy
arrays, the JAX package's protocol. Nothing here touches ``torch``.
"""

from __future__ import annotations

import multiprocessing as mp
import time
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

__all__ = ['SharedState', 'CameraPose', 'LaunchConfig']


@dataclass
class CameraPose:
    """Pickle-friendly camera pose crossing the process boundary."""
    c2w: np.ndarray                 # (4, 4)
    width: int = 800
    height: int = 800
    fov_y_deg: float = 45.0
    timestamp: float = 0.0


@dataclass
class LaunchConfig:
    """Viewer launch settings (reference: ICGui LaunchParser/LaunchConfig)."""
    host: str = '127.0.0.1'
    port: int = 8642
    width: int = 800
    height: int = 800
    resolution_factor: float = 1.0
    checkpoint_path: Optional[str] = None


class SharedState:
    """Bidirectional shared state; every field follows the reference's
    protocol."""

    def __init__(self, manager: Optional[mp.managers.SyncManager] = None):
        # spawn: a forked child cannot use the parent's CUDA context, and
        # forking a process with threads is unsafe (the reference likewise
        # forces 'spawn', Framework.py:124).
        ctx = mp.get_context('spawn')
        self._manager = manager or ctx.Manager()
        self._dict = self._manager.dict()
        self._last_seq_seen = -1
        self._dict.update({
            '_frame': None,
            '_frame_seq': 0,
            'configurable_advertisements': {},
            'configurable_changes': {},
            'view': None,                 # CameraPose requested by the viewer
            'gt_index': None,
            'gt_split': 'train',
            'screenshot_view': None,
            'terminate_training': False,
            'is_training': False,
            'training_iteration': 0,
            'fps': 0.0,
        })

    def __getstate__(self):
        # The SyncManager is process-local; only the dict proxy crosses the
        # boundary (it reconnects to the manager's server by address).
        return {'_dict': self._dict, '_last_seq_seen': -1}

    def __setstate__(self, state):
        self._manager = None
        self._dict = state['_dict']
        self._last_seq_seen = state['_last_seq_seen']

    # -- trainer -> viewer --------------------------------------------------------
    def push_frame(self, frame: np.ndarray) -> None:
        """Latest-wins frame slot (the viewer never sees a stale backlog)."""
        self._dict['_frame'] = np.ascontiguousarray(frame)
        self._dict['_frame_seq'] = int(self._dict.get('_frame_seq', 0)) + 1

    def pop_frame(self, timeout: float = 0.5) -> Optional[np.ndarray]:
        """Return the newest unseen frame, or None after ``timeout``."""
        deadline = time.monotonic() + timeout
        while True:
            seq = int(self._dict.get('_frame_seq', 0))
            if seq != self._last_seq_seen:
                self._last_seq_seen = seq
                frame = self._dict.get('_frame')
                if frame is not None:
                    return frame
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.01)

    # -- generic field access -----------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._dict.get(key)

    def __setitem__(self, key: str, value: Any) -> None:
        self._dict[key] = value

    @property
    def terminate_training(self) -> bool:
        return bool(self._dict.get('terminate_training', False))

    def advertise_configurables(self, advertisements: dict) -> None:
        """(reference: GuiTrainer.py:79-90)"""
        self._dict['configurable_advertisements'] = advertisements

    def take_config_changes(self) -> dict:
        changes = dict(self._dict.get('configurable_changes') or {})
        if changes:
            self._dict['configurable_changes'] = {}
        return changes
