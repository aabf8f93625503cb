"""GUI-attached training: live frames streamed from the training loop.

Port of nerficg_tpu/gui/trainer.py (reference: src/Methods/Base/
GuiTrainer.py:51-233): a pre-training callback spawns the viewer process,
a callback every ``GUI_RENDER_INTERVAL`` iterations applies the viewer's
camera and renderer-config changes and streams a rendered frame and the
FPS, the trainer stops when the viewer posts ``/terminate``, and after
training the model keeps rendering until the viewer closes or terminates.

``with_gui(TrainerCls)`` builds a GUI-enabled subclass of any method's
trainer (the reference's GuiTrainer inheritance, applied dynamically).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nerficg_torch.cameras.perspective import PerspectiveCamera
from nerficg_torch.cameras.pose import fov_to_focal
from nerficg_torch.core.errors import catch
from nerficg_torch.core.logging import Logger
from nerficg_torch.data.types import View
from nerficg_torch.gui.state import CameraPose, LaunchConfig, SharedState
from nerficg_torch.methods.base.callbacks import (post_training_callback,
                                                  pre_training_callback,
                                                  training_callback)

__all__ = ['GuiTrainerMixin', 'with_gui', 'FPSRollingAverage']


class FPSRollingAverage:
    """(reference: ICGui.util.FPSRollingAverage)"""

    def __init__(self, window: int = 20):
        self._times: list[float] = []
        self.window = window

    def tick(self) -> float:
        now = time.perf_counter()
        self._times.append(now)
        self._times = self._times[-self.window:]
        if len(self._times) < 2:
            return 0.0
        return (len(self._times) - 1) / (self._times[-1] - self._times[0])


def _push(state: SharedState, pending) -> None:
    """Hand a frame whose copy to the host was started to the viewer, once
    the copy has finished."""
    host, copied = pending
    if copied is not None:
        copied.synchronize()
    state.push_frame(host.numpy())


class GuiTrainerMixin:
    """Adds the live-view callbacks to a trainer (combine via
    ``with_gui``)."""

    GUI_RENDER_INTERVAL = 25     # iterations between live frames
    GUI_PORT = 8642

    @pre_training_callback(priority=9000)
    def _gui_init(self, dataset) -> None:
        """(reference: GuiTrainer.py:51-77)"""
        from nerficg_torch.gui.web_viewer import launch_gui_process
        config = LaunchConfig(port=int(self.GUI_PORT))
        self._gui_state, self._gui_process = launch_gui_process(config)
        self._gui_fps = FPSRollingAverage()
        self._gui_view: View | None = None
        self._gui_pending_frame = None
        self._gui_state['is_training'] = True
        self._gui_state.advertise_configurables(
            dict(getattr(self.renderer, '_configuration', {})))
        Logger.info(f'GUI viewer at http://127.0.0.1:{self.GUI_PORT}')

    def _pose_to_view(self, pose: CameraPose, dataset) -> View:
        """A viewer pose as a view: a pinhole camera of the pose's size and
        vertical FOV with the dataset's camera settings."""
        height = int(pose.height)
        focal = fov_to_focal(np.deg2rad(pose.fov_y_deg), height)
        camera = PerspectiveCamera(width=int(pose.width), height=height,
                                   focal_x=focal, focal_y=focal,
                                   settings=dataset.camera_settings)
        return View(camera=camera, c2w=pose.c2w, timestamp=pose.timestamp)

    def _stream_frame(self, state: SharedState, rgb: torch.Tensor) -> None:
        """Double-buffered hand-off: start copying the new frame to the
        host and push the previous one, whose copy has overlapped the work
        queued since. On the card the copy goes into pinned memory
        (a non-blocking copy into pageable memory would be synchronous)
        and is followed by an event; the previous frame is pushed only
        after its event, so the viewer never gets a frame still being
        written (reference: GuiTrainer.py streams through pinned copies)."""
        rgb = rgb.detach()
        if rgb.device.type == 'cuda':
            host = torch.empty(rgb.shape, dtype=rgb.dtype, pin_memory=True)
            host.copy_(rgb, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(torch.cuda.current_stream(rgb.device))
        else:
            host, copied = rgb, None
        pending = getattr(self, '_gui_pending_frame', None)
        self._gui_pending_frame = (host, copied)
        if pending is not None:
            _push(state, pending)

    def _flush_frame(self, state: SharedState) -> None:
        pending = getattr(self, '_gui_pending_frame', None)
        self._gui_pending_frame = None
        if pending is not None:
            _push(state, pending)

    @training_callback(priority=5, iteration_stride='GUI_RENDER_INTERVAL')
    @catch()
    def _gui_render_frame(self, dataset, iteration: int) -> None:
        """(reference: GuiTrainer.py:126-191)"""
        state = getattr(self, '_gui_state', None)
        if state is None or not self._gui_process.is_alive():
            return
        if state.terminate_training:
            Logger.warning('GUI requested training termination')
            raise KeyboardInterrupt
        # Renderer config changes from the viewer (reference: :134-146).
        for key, value in state.take_config_changes().items():
            if hasattr(self.renderer, key):
                setattr(self.renderer, key, value)
        pose = state['view']
        if pose is not None:
            self._gui_view = self._pose_to_view(pose, dataset)
        elif self._gui_view is None and dataset.subsets['train']:
            self._gui_view = dataset.subsets['train'][0].to_simple()
        if self._gui_view is None:
            return
        out = self.renderer.render_image(self._gui_view)
        self._stream_frame(state, out['rgb'])
        state['training_iteration'] = iteration
        state['fps'] = self._gui_fps.tick()

    @post_training_callback(priority=50)
    @catch()
    def _gui_post_training(self, dataset) -> None:
        """Keep rendering after training until the viewer closes or posts
        ``/terminate`` (reference: GuiTrainer.py:92-99)."""
        state = getattr(self, '_gui_state', None)
        if state is None:
            return
        state['is_training'] = False
        self._flush_frame(state)
        Logger.info('training done; the viewer stays interactive until it '
                    'closes or posts /terminate')
        try:
            while self._gui_process.is_alive() and \
                    not state.terminate_training:
                pose = state['view']
                if pose is not None:
                    self._gui_view = self._pose_to_view(pose, dataset)
                if self._gui_view is not None:
                    out = self.renderer.render_image(self._gui_view)
                    self._stream_frame(state, out['rgb'])
                    state['fps'] = self._gui_fps.tick()
                else:
                    time.sleep(0.1)
        except KeyboardInterrupt:
            pass
        self._flush_frame(state)
        self._gui_process.terminate()
        self._gui_process.join(timeout=10)


def with_gui(trainer_cls: type) -> type:
    """A GUI-enabled subclass of ``trainer_cls``."""
    return type(f'Gui{trainer_cls.__name__}', (GuiTrainerMixin, trainer_cls),
                {})
