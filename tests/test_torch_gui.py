"""The port's interactive viewer against the JAX package on the CPU.

* ``SharedState``: tests/test_gui.py's three cases on the port.
* The web viewer in a thread on a free port: ``/``, ``/status`` (the JAX
  viewer's JSON keys), 404s; ``POST /camera`` sets a pose equal to the JAX
  package's ``_orbit_pose`` bit for bit; ``/frame.jpg`` is byte-equal to
  the JAX package's ``_encode_jpeg`` of the same frame (PIL, quality 90);
  ``POST /terminate``.
* ``_pose_to_view``: the camera and c2w of the JAX package's.
* GUI-attached NeRF training on a 32x32 scene with the viewer in a thread:
  every frame pushed is the render that the callback made, in order; after
  training a posted pose's frame equals ``render_image`` of that pose,
  bit for bit; through ``gui --train --device cpu``, ``/terminate`` stops
  the loop and final.ckpt is written.
* The viewer as a real spawned process (``launch_gui_process``), every
  wait bounded by a deadline.
* The checkpoint runner on a JAX-trained NeRF checkpoint: a posted pose's
  frame against the JAX package's render of that pose, within
  tests/test_torch_nerf.py's render tolerance (>= 45 dB, mean absolute
  error <= 1e-4).

On a card, tests/test_torch_cuda_viewer.py holds the frames streamed
through the pinned-memory hand-off to direct renders.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import nerficg_torch.gui.web_viewer as twv
import nerficg_tpu.gui.web_viewer as jwv
from nerficg_torch.core.config import ConfigNode as TConfig
from nerficg_torch.core.logging import Logger as TLogger
from nerficg_torch.core.registry import Datasets as TDatasets
from nerficg_torch.core.registry import Methods as TMethods
from nerficg_torch.core.setup import Directories as TDirectories
from nerficg_torch.data.synthetic import make_textured_scene
from nerficg_torch.gui.state import CameraPose, LaunchConfig, SharedState
from nerficg_torch.gui.trainer import GuiTrainerMixin, with_gui
from nerficg_tpu.core.config import ConfigNode as JConfig
from nerficg_tpu.core.registry import Datasets as JDatasets
from nerficg_tpu.core.registry import Methods as JMethods
from nerficg_tpu.core.setup import Directories as JDirectories
from nerficg_tpu.gui.state import CameraPose as JCameraPose
from nerficg_tpu.gui.state import LaunchConfig as JLaunchConfig
from nerficg_tpu.gui.state import SharedState as JSharedState
from nerficg_tpu.gui.trainer import GuiTrainerMixin as JGuiTrainerMixin
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TLogger.set_level('SILENT')

# tests/test_torch_nerf.py's render tolerance against the JAX package.
MIN_PSNR_DB = 45.0
RENDER_MAE = 1e-4
# Bound on every wait for the viewer, seconds.
DEADLINE_S = 60.0


def _get(port, path):
    return urllib.request.urlopen(f'http://127.0.0.1:{port}{path}',
                                  timeout=10).read()


def _post(port, path, body=b''):
    request = urllib.request.Request(f'http://127.0.0.1:{port}{path}',
                                     data=body, method='POST')
    return urllib.request.urlopen(request, timeout=10).status


def _wait(condition, what):
    deadline = time.monotonic() + DEADLINE_S
    while not condition():
        if time.monotonic() > deadline:
            raise AssertionError(f'timed out waiting for {what}')
        time.sleep(0.02)


def _serve(module, state, config, monkeypatch):
    """``module.run_viewer`` in a daemon thread; returns its server."""
    holder = {}

    class Grabber(module.ThreadingHTTPServer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            holder['server'] = self

    with monkeypatch.context() as patch:
        patch.setattr(module, 'ThreadingHTTPServer', Grabber)
        threading.Thread(target=module.run_viewer, args=(state, config),
                         daemon=True).start()
        _wait(lambda: 'server' in holder, 'the viewer to listen')
    return holder['server']


@pytest.fixture()
def viewer(monkeypatch):
    """The port's viewer in a thread on a free port, 40x30 poses."""
    state = SharedState()
    server = _serve(twv, state, LaunchConfig(port=0, width=40, height=30),
                    monkeypatch)
    yield state, server.server_address[1]
    server.shutdown()


class _ThreadViewer:
    """``launch_gui_process`` with the viewer in a thread of this process
    (32x32 poses): the process handle's ``is_alive``, ``terminate`` and
    ``join``, and the state, port and every frame pushed."""

    def __init__(self, monkeypatch):
        self.monkeypatch = monkeypatch
        self.state = None
        self.pushed: list[np.ndarray] = []

    def __call__(self, config):
        self.state = SharedState()
        push = self.state.push_frame

        def recorded(frame):
            self.pushed.append(np.array(frame))
            push(frame)

        self.state.push_frame = recorded
        self.server = _serve(twv, self.state,
                             LaunchConfig(port=0, width=32, height=32),
                             self.monkeypatch)
        self.port = self.server.server_address[1]
        self.alive = True
        return self.state, self

    def is_alive(self):
        return self.alive

    def terminate(self):
        if self.alive:
            self.alive = False
            self.server.shutdown()

    def join(self, timeout=None):
        pass


# -- SharedState -------------------------------------------------------------

class TestSharedState:
    def test_fields_roundtrip(self):
        state = SharedState()
        state['training_iteration'] = 42
        state['is_training'] = True
        assert state['training_iteration'] == 42
        assert state['is_training'] is True
        assert not state.terminate_training
        state['terminate_training'] = True
        assert state.terminate_training

    def test_frame_channel_latest_wins(self):
        state = SharedState()
        for i in range(5):
            state.push_frame(np.full((2, 2, 3), i, np.float32))
        frame = state.pop_frame()
        assert frame is not None and float(frame[0, 0, 0]) == 4
        assert state.pop_frame(timeout=0.05) is None

    def test_config_changes_consumed_once(self):
        state = SharedState()
        state['configurable_changes'] = {'MAX_PER_TILE': 128}
        assert state.take_config_changes() == {'MAX_PER_TILE': 128}
        assert state.take_config_changes() == {}


# -- the web viewer ----------------------------------------------------------

def test_index_status_and_404(viewer, monkeypatch):
    state, port = viewer
    state['training_iteration'] = 7
    state['is_training'] = True
    state['fps'] = 12.5
    assert b'nerficg-torch viewer' in _get(port, '/')
    status = json.loads(_get(port, '/status'))
    assert status == {'training_iteration': 7, 'is_training': True,
                      'fps': 12.5}
    j_state = JSharedState()
    j_server = _serve(jwv, j_state, JLaunchConfig(port=0), monkeypatch)
    try:
        j_status = json.loads(_get(j_server.server_address[1], '/status'))
    finally:
        j_server.shutdown()
    assert list(status) == list(j_status)
    for method in (_get, _post):
        with pytest.raises(urllib.error.HTTPError) as info:
            method(port, '/nope')
        assert info.value.code == 404


@pytest.mark.parametrize('theta,phi,radius', [
    (0.0, 0.0, 4.0), (0.5, 0.2, 3.0), (-2.3, 1.4, 0.2), (3.1, -0.7, 7.5)])
def test_camera_post_is_jax_orbit_pose(viewer, theta, phi, radius):
    state, port = viewer
    body = json.dumps({'theta': theta, 'phi': phi, 'radius': radius})
    assert _post(port, '/camera', body.encode()) == 204
    pose = state['view']
    want = jwv._orbit_pose(theta, phi, radius, 40, 30)
    np.testing.assert_array_equal(pose.c2w, want.c2w)
    assert (pose.width, pose.height, pose.fov_y_deg, pose.timestamp) == \
        (want.width, want.height, want.fov_y_deg, want.timestamp)
    assert np.linalg.norm(pose.c2w[:3, 3]) == pytest.approx(radius)


def test_frame_jpeg_is_jax_encoding(viewer):
    state, port = viewer
    frame = np.random.default_rng(0).uniform(-0.1, 1.1, (30, 40, 3)).astype(
        np.float32)
    state.push_frame(frame)
    want = jwv._encode_jpeg(frame)
    assert want == twv._encode_jpeg(frame)
    _wait(lambda: _get(port, '/frame.jpg') == want, 'the frame')


def test_terminate_post(viewer):
    state, port = viewer
    assert not state.terminate_training
    assert _post(port, '/terminate') == 204
    assert state.terminate_training


def test_viewer_imports_no_torch():
    """The spawned viewer loads ``gui.state`` and ``gui.web_viewer`` only:
    neither imports torch, so the child cannot initialise CUDA."""
    import subprocess
    import sys
    code = ('import sys, nerficg_torch.gui.web_viewer; '
            'print("torch" in sys.modules)')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == 'False', out.stderr


def test_spawned_viewer_process():
    """``launch_gui_process`` for real: a spawned viewer on a free port
    serves the status, takes a pose, encodes a pushed frame and a
    terminate; it is stopped within the deadline."""
    with socket.socket() as probe:
        probe.bind(('127.0.0.1', 0))
        port = probe.getsockname()[1]
    state, process = twv.launch_gui_process(LaunchConfig(port=port))
    try:
        def listening():
            try:
                return json.loads(_get(port, '/status'))['fps'] == 0.0
            except OSError:
                return False
        _wait(listening, 'the spawned viewer')
        _post(port, '/camera', b'{"theta": 0.5, "radius": 2.0}')
        pose = state['view']
        np.testing.assert_array_equal(
            pose.c2w, jwv._orbit_pose(0.5, 0.0, 2.0, 800, 800).c2w)
        frame = np.random.default_rng(1).random((16, 24, 3)).astype(
            np.float32)
        state.push_frame(frame)
        want = jwv._encode_jpeg(frame)
        _wait(lambda: _get(port, '/frame.jpg') == want, 'the frame')
        _post(port, '/terminate')
        assert state.terminate_training
    finally:
        process.terminate()
        process.join(timeout=DEADLINE_S)
        if process.is_alive():
            process.kill()
    assert not process.is_alive()


# -- training and checkpoints with the viewer --------------------------------

@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    return make_textured_scene(tmp_path_factory.mktemp('gui_scene'),
                               image_size=32, n_train=8, n_test=2)


def _nerf_config(scene, iterations):
    """tests/test_torch_nerf.py's small NeRF."""
    return {'GLOBAL': {'METHOD_TYPE': 'NeRF', 'DATASET_TYPE': 'NeRF',
                       'RANDOM_SEED': 0, 'LOG_LEVEL': 'SILENT'},
            'DATASET': {'PATH': str(scene)},
            'MODEL': {'NUM_LAYERS': 3, 'WIDTH': 64, 'SKIP_LAYER': 2,
                      'POSITION_FREQUENCIES': 6, 'DIRECTION_FREQUENCIES': 2,
                      'USE_COARSE': True},
            'RENDERER': {'RAY_BATCH_SIZE': 1024, 'N_SAMPLES': 48,
                         'COARSE_RATIO': 0.5},
            'TRAINING': {'NUM_ITERATIONS': iterations, 'RAYS_PER_BATCH': 128,
                         'LR_INIT': 5e-3, 'LR_FINAL': 5e-4,
                         'RENDER_TESTSET': False, 'MODEL_NAME': 'gui'}}


def test_pose_to_view_matches_jax(scene):
    cfg = _nerf_config(scene, 1)
    c2w = jwv._orbit_pose(0.7, -0.3, 3.5, 40, 30).c2w
    got = GuiTrainerMixin()._pose_to_view(
        CameraPose(c2w=c2w, width=40, height=30, fov_y_deg=50.0,
                   timestamp=0.25), TDatasets.get_dataset(TConfig(cfg)))
    want = JGuiTrainerMixin()._pose_to_view(
        JCameraPose(c2w=c2w, width=40, height=30, fov_y_deg=50.0,
                    timestamp=0.25), JDatasets.get_dataset(JConfig(cfg)))
    np.testing.assert_array_equal(got.c2w, want.c2w)
    assert got.timestamp == want.timestamp == 0.25
    for name in ('width', 'height', 'focal_x', 'focal_y', 'center_x',
                 'center_y', 'near', 'far'):
        assert getattr(got.camera, name) == getattr(want.camera, name), name
    np.testing.assert_array_equal(got.camera.background_color,
                                  want.camera.background_color)


def _gui_trainer(scene, iterations, interval, monkeypatch):
    viewer = _ThreadViewer(monkeypatch)
    monkeypatch.setattr(twv, 'launch_gui_process', viewer)
    cfg = TConfig(_nerf_config(scene, iterations))
    plain = TMethods.get_training_instance(cfg, device='cpu')
    trainer = with_gui(type(plain))(cfg, plain.model, plain.renderer)
    trainer.GUI_RENDER_INTERVAL = interval
    return trainer, TDatasets.get_dataset(cfg), viewer


def test_gui_training_streams_rendered_frames(scene, tmp_path, monkeypatch):
    """12 iterations, a frame every 4th: the renders at iterations 0, 4
    and 8 of the first train view; then, after training, a posted pose
    rendered until /terminate. Every render is pushed, in order, and the
    pose's frame is the final model's render of it."""
    monkeypatch.setattr(TDirectories, 'base', tmp_path)
    trainer, dataset, viewer = _gui_trainer(scene, 12, 4, monkeypatch)
    renders = []
    render = trainer.renderer.render_image

    def recorded(view, *args, **kwargs):
        out = render(view, *args, **kwargs)
        renders.append(out['rgb'].numpy().copy())
        return out

    monkeypatch.setattr(trainer.renderer, 'render_image', recorded)

    def client():
        _wait(lambda: viewer.state is not None and
              not viewer.state['is_training'] and
              viewer.state['training_iteration'] == 8, 'training to end')
        status = json.loads(_get(viewer.port, '/status'))
        assert status['is_training'] is False
        _post(viewer.port, '/camera',
              b'{"theta": 0.4, "phi": 0.3, "radius": 4.0}')
        count = len(viewer.pushed)
        _wait(lambda: len(viewer.pushed) >= count + 3, 'the pose\'s frames')
        _post(viewer.port, '/terminate')

    helper = threading.Thread(target=client, daemon=True)
    helper.start()
    trainer.run(dataset)
    helper.join(timeout=DEADLINE_S)
    assert not helper.is_alive()
    assert trainer.model.num_iterations_trained == 12
    assert (trainer.output_dir / 'checkpoints' / 'final.ckpt').exists()
    assert len(viewer.pushed) == len(renders) >= 6
    for got, want in zip(viewer.pushed, renders):
        np.testing.assert_array_equal(got, want)
    assert all(r.shape == (32, 32, 3) for r in renders)
    view = GuiTrainerMixin()._pose_to_view(viewer.state['view'], dataset)
    np.testing.assert_array_equal(
        viewer.pushed[-1], render(view)['rgb'].numpy())
    assert not np.array_equal(viewer.pushed[-1], viewer.pushed[2])
    assert not viewer.is_alive()


def test_terminate_stops_training(scene, tmp_path, monkeypatch):
    """``gui --train`` (a frame every 25 iterations) stopped by
    ``/terminate`` at iteration 25 or later: the loop ends, the
    post-training callbacks run, final.ckpt is written."""
    from nerficg_torch.core.config import save_config
    from nerficg_torch.scripts import gui
    monkeypatch.setattr(TDirectories, 'base', tmp_path)
    viewer = _ThreadViewer(monkeypatch)
    monkeypatch.setattr(twv, 'launch_gui_process', viewer)
    save_config(TConfig(_nerf_config(scene, 400)), tmp_path / 'cfg.yaml')

    def client():
        _wait(lambda: viewer.state is not None and
              viewer.state['training_iteration'] >= 25, 'iteration 25')
        _post(viewer.port, '/terminate')

    helper = threading.Thread(target=client, daemon=True)
    helper.start()
    trainer = gui.main(['--train', '-c', str(tmp_path / 'cfg.yaml'),
                        '--device', 'cpu', '--port', '0'])
    helper.join(timeout=DEADLINE_S)
    assert 25 < trainer.model.num_iterations_trained < 400
    assert (trainer.output_dir / 'checkpoints' / 'final.ckpt').exists()
    assert not viewer.is_alive()


def test_checkpoint_runner_on_jax_checkpoint(scene, tmp_path, monkeypatch):
    """A JAX-trained run dir viewed with the port (``--device cpu``): a
    posted pose's frame against the JAX package's render of that pose."""
    from nerficg_torch.scripts import gui
    monkeypatch.setattr(JDirectories, 'base', tmp_path)
    cfg = _nerf_config(scene, 5)
    jt = JMethods.get_training_instance(JConfig(cfg))
    jt.run(JDatasets.get_dataset(JConfig(cfg)))
    run_dir = jt.output_dir

    viewer = _ThreadViewer(monkeypatch)
    monkeypatch.setattr(twv, 'launch_gui_process', viewer)
    runner = threading.Thread(target=gui.main,
                              args=(['-d', str(run_dir), '--port', '0',
                                     '--device', 'cpu'],), daemon=True)
    runner.start()
    _wait(lambda: len(viewer.pushed) >= 1, 'the first frame')
    _post(viewer.port, '/camera', b'{"theta": 0.9, "phi": -0.2}')
    count = len(viewer.pushed)
    _wait(lambda: len(viewer.pushed) >= count + 2, 'the pose\'s frame')
    _post(viewer.port, '/terminate')
    runner.join(timeout=DEADLINE_S)
    assert not runner.is_alive() and not viewer.is_alive()

    pose = jwv._orbit_pose(0.9, -0.2, 4.0, 32, 32)
    j_view = JGuiTrainerMixin()._pose_to_view(
        pose, JDatasets.get_dataset(JConfig(cfg)))
    j_model = JMethods.get_model(
        JConfig(cfg), checkpoint=str(run_dir / 'checkpoints' / 'final.ckpt'))
    want = np.asarray(JMethods.get_renderer(JConfig(cfg), j_model)
                      .render_image(j_view)['rgb'])
    got = viewer.pushed[-1]
    assert got.shape == want.shape == (32, 32, 3)
    assert float(want.std()) > 0.01
    psnr = -10 * np.log10(max(float(np.mean((got - want) ** 2)), 1e-20))
    assert psnr >= MIN_PSNR_DB, f'{psnr:.1f} dB'
    assert float(np.abs(got - want).mean()) <= RENDER_MAE
