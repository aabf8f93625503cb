"""Dependency-free web viewer: MJPEG frame stream + orbit camera controls.

Port of nerficg_tpu/gui/web_viewer.py (reference: the ICGui SDL3/OpenGL/
imgui viewer process, SURVEY §2.15). A small stdlib HTTP server, run in a
spawned child process: frames stream as MJPEG (``/stream``, ``/frame.jpg``),
mouse-drag orbit and wheel zoom post camera poses (``POST /camera``) back
through ``SharedState``, ``/status`` reports iteration, FPS and whether
training runs, and ``POST /terminate`` asks the trainer to stop. The HTTP
protocol, its JSON keys and the JPEG quality (90) are the JAX package's, so
a client of either package works with both. The child imports neither
``torch`` nor anything that initialises CUDA.
"""

from __future__ import annotations

import io
import json
import math
import multiprocessing as mp
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from nerficg_torch.cameras.pose import look_at
from nerficg_torch.gui.state import CameraPose, LaunchConfig, SharedState

__all__ = ['launch_gui_process', 'run_viewer']

_PAGE = """<!DOCTYPE html>
<html><head><title>nerficg-torch viewer</title><style>
body { margin:0; background:#111; color:#ddd; font-family:monospace; }
#bar { padding:6px 12px; background:#1b1b1b; }
#frame { display:block; margin:auto; cursor:grab; }
</style></head><body>
<div id="bar">nerficg-torch &mdash; <span id="status">connecting...</span></div>
<img id="frame" src="/stream" draggable="false"/>
<script>
let theta = 0.0, phi = 0.0, radius = 4.0, drag = null;
const img = document.getElementById('frame');
function post() {
  fetch('/camera', {method:'POST', body: JSON.stringify({theta, phi, radius})});
}
img.addEventListener('mousedown', e => { drag = [e.clientX, e.clientY]; });
window.addEventListener('mouseup', () => { drag = null; });
window.addEventListener('mousemove', e => {
  if (!drag) return;
  theta += (e.clientX - drag[0]) * 0.01;
  phi = Math.max(-1.4, Math.min(1.4, phi + (e.clientY - drag[1]) * 0.01));
  drag = [e.clientX, e.clientY];
  post();
});
img.addEventListener('wheel', e => {
  radius = Math.max(0.2, radius * (e.deltaY > 0 ? 1.1 : 0.9));
  post(); e.preventDefault();
});
setInterval(async () => {
  const s = await (await fetch('/status')).json();
  document.getElementById('status').textContent =
    `iter ${s.training_iteration} | ${s.fps.toFixed(1)} fps | ` +
    (s.is_training ? 'training' : 'idle');
}, 1000);
</script></body></html>"""


def _orbit_pose(theta: float, phi: float, radius: float,
                width: int, height: int) -> CameraPose:
    eye = np.array([radius * math.cos(phi) * math.sin(theta),
                    radius * math.sin(phi),
                    -radius * math.cos(phi) * math.cos(theta)])
    return CameraPose(c2w=look_at(eye, np.zeros(3)), width=width,
                      height=height)


def _encode_jpeg(frame: np.ndarray) -> bytes:
    from PIL import Image
    img = Image.fromarray((np.clip(frame, 0, 1) * 255).astype(np.uint8))
    buf = io.BytesIO()
    img.save(buf, format='JPEG', quality=90)
    return buf.getvalue()


def run_viewer(state: SharedState, config: LaunchConfig) -> None:
    """GUI process entry: serve the viewer until terminated."""
    latest_jpeg: list[bytes] = [b'']
    stop = threading.Event()

    def frame_pump():
        while not stop.is_set():
            frame = state.pop_frame(timeout=0.5)
            if frame is not None:
                latest_jpeg[0] = _encode_jpeg(frame)

    pump = threading.Thread(target=frame_pump, daemon=True)
    pump.start()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_GET(self):
            if self.path == '/':
                body = _PAGE.encode()
                self.send_response(200)
                self.send_header('Content-Type', 'text/html')
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == '/status':
                body = json.dumps({
                    'training_iteration': state['training_iteration'],
                    'is_training': state['is_training'],
                    'fps': state['fps'] or 0.0,
                }).encode()
                self.send_response(200)
                self.send_header('Content-Type', 'application/json')
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == '/stream':
                self.send_response(200)
                self.send_header(
                    'Content-Type',
                    'multipart/x-mixed-replace; boundary=frameboundary')
                self.end_headers()
                try:
                    while not stop.is_set():
                        data = latest_jpeg[0]
                        if data:
                            self.wfile.write(b'--frameboundary\r\n')
                            self.wfile.write(b'Content-Type: image/jpeg\r\n')
                            self.wfile.write(
                                f'Content-Length: {len(data)}\r\n\r\n'.encode())
                            self.wfile.write(data)
                            self.wfile.write(b'\r\n')
                        time.sleep(1 / 30)
                except (BrokenPipeError, ConnectionResetError):
                    pass
            elif self.path == '/frame.jpg':
                data = latest_jpeg[0] or _encode_jpeg(
                    np.zeros((8, 8, 3), np.float32))
                self.send_response(200)
                self.send_header('Content-Type', 'image/jpeg')
                self.send_header('Content-Length', str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            else:
                self.send_response(404)
                self.end_headers()

        def do_POST(self):
            if self.path == '/camera':
                length = int(self.headers.get('Content-Length', 0))
                params = json.loads(self.rfile.read(length) or b'{}')
                state['view'] = _orbit_pose(
                    float(params.get('theta', 0.0)),
                    float(params.get('phi', 0.0)),
                    float(params.get('radius', 4.0)),
                    config.width, config.height)
                self.send_response(204)
                self.end_headers()
            elif self.path == '/terminate':
                state['terminate_training'] = True
                self.send_response(204)
                self.end_headers()
            else:
                self.send_response(404)
                self.end_headers()

    server = ThreadingHTTPServer((config.host, config.port), Handler)
    try:
        server.serve_forever(poll_interval=0.25)
    finally:
        stop.set()


def launch_gui_process(config: LaunchConfig | None = None
                       ) -> tuple[SharedState, mp.Process]:
    """Spawn the viewer process (reference:
    ICGui.util.Runner.launch_gui_process).

    Returns (shared_state, process); the caller streams frames via
    ``shared_state.push_frame`` and polls ``shared_state['view']``.
    """
    config = config or LaunchConfig()
    state = SharedState()
    process = mp.get_context('spawn').Process(
        target=run_viewer, args=(state, config), daemon=True)
    process.start()
    return state, process
