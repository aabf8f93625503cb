"""The viewer's frame hand-off on a card. Marked ``cuda``: without a card
the test skips. On a machine with one (no JAX needed):
``python -m pytest --noconftest tests/test_torch_cuda_viewer.py -m cuda``.

The GUI trainer copies each frame into pinned host memory without waiting
and pushes it one render later, after the copy's event; a push that did
not wait for the event could hand the viewer a frame still being written.
Here every frame pushed must equal its view's direct render, bit for bit
(the packed 3DGS forward sums in a fixed order)."""

import numpy as np
import pytest
import torch

from nerficg_torch.cameras.perspective import PerspectiveCamera
from nerficg_torch.core.config import ConfigNode
from nerficg_torch.data.types import View
from nerficg_torch.gui.state import SharedState
from nerficg_torch.gui.trainer import GuiTrainerMixin
from nerficg_torch.gui.web_viewer import _orbit_pose
from nerficg_torch.methods.gaussian_splatting.renderer import \
    GaussianSplattingRenderer
from nerficg_torch.scripts.kernel_timing import gs_model

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def test_stream_frame_matches_direct_render(cuda):
    """Six 800x800 frames of bench.py's 100k-Gaussian model through
    ``_stream_frame`` (and ``_flush_frame`` for the last)."""
    model = gs_model('cuda')
    renderer = GaussianSplattingRenderer(ConfigNode({}), model)
    views = [View(camera=PerspectiveCamera(800, 800),
                  c2w=_orbit_pose(theta, 0.2, 4.0, 800, 800).c2w)
             for theta in np.linspace(0.0, 3.0, 6)]
    state = SharedState()
    pushed = []
    state.push_frame = lambda frame: pushed.append(np.array(frame))
    mixin = GuiTrainerMixin()
    for view in views:
        mixin._stream_frame(state, renderer.render_image(view)['rgb'])
    assert len(pushed) == len(views) - 1
    mixin._flush_frame(state)
    assert len(pushed) == len(views)
    for got, view in zip(pushed, views):
        want = renderer.render_image(view)['rgb'].cpu().numpy()
        assert want.shape == (800, 800, 3) and want.std() > 0.01
        np.testing.assert_array_equal(got, want)
