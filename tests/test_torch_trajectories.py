"""The port's camera trajectories against the JAX package on the CPU.

All seven built-in trajectories on a Mip-NeRF-360-layout COLMAP capture
(PCA-aligned, its bounding box from the SfM cloud) and on a D-NeRF scene
(timestamps, so bullet_time freezes one and the others interpolate them):
the same names, frame counts, c2w (float64, np.array_equal), timestamps,
cameras and frame indices as JAX's, as ``inference -s <name>`` adds them.
"""

import numpy as np
import pytest

from nerficg_torch.core.config import ConfigNode as TConfig
from nerficg_torch.core.logging import Logger as TLogger
from nerficg_torch.core.registry import Datasets as TDatasets
from nerficg_torch.data.synthetic import (make_dynamic_textured_scene,
                                          make_textured_scene)
from nerficg_torch.visual.trajectories import \
    CameraTrajectory as TTrajectory
from nerficg_tpu.core.config import ConfigNode as JConfig
from nerficg_tpu.core.registry import Datasets as JDatasets
from nerficg_tpu.visual.trajectories import CameraTrajectory as JTrajectory
from test_torch_colmap import write_capture
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TLogger.set_level('SILENT')

NAMES = ['bullet_time', 'ellipse_path', 'fancy_zoom', 'fixed_view',
         'novel_view', 'spiral_path', 'stabilized_path']


@pytest.fixture(scope='module')
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp('trajectories')
    scene = make_textured_scene(root / 'scene', image_size=32, n_train=10,
                                n_test=2)
    capture = write_capture(root / 'capture', scene, image_dir='images_4',
                            model_scale=4, rows=(4, 28))
    dynamic = make_dynamic_textured_scene(root / 'dynamic', image_size=16,
                                          n_train=9, n_test=2)
    return {'MipNeRF360': capture, 'DNeRF': dynamic}


def test_registry_lists_seven():
    assert TTrajectory.list_options() == JTrajectory.list_options() == NAMES


@pytest.mark.parametrize('name', NAMES)
@pytest.mark.parametrize('kind', ['MipNeRF360', 'DNeRF'])
def test_trajectory_matches_jax(datasets, kind, name):
    cfg = {'GLOBAL': {'DATASET_TYPE': kind},
           'DATASET': {'PATH': str(datasets[kind])}}
    t = TDatasets.get_dataset(TConfig(cfg))
    j = JDatasets.get_dataset(JConfig(cfg))
    frames = 120 if name != 'stabilized_path' else None
    TTrajectory.get(name).add_to_dataset(t)
    JTrajectory.get(name).add_to_dataset(j)
    got, want = t.subsets[name], j.subsets[name]
    assert name in t.SUBSETS
    assert len(got) == len(want) == (frames or len(t.subsets['train']))
    for g, w in zip(got, want):
        assert np.array_equal(g.c2w, w.c2w)
        assert g.timestamp == w.timestamp
        assert g.frame_idx == w.frame_idx
        assert g.camera._intrinsics_key() == w.camera._intrinsics_key()
        assert (g.camera.width, g.camera.height) == \
            (w.camera.width, w.camera.height)
    stamps = {g.timestamp for g in got}
    if kind == 'DNeRF' and name in ('bullet_time', 'novel_view'):
        assert len(stamps) == 1
    elif kind == 'DNeRF' and name != 'stabilized_path':
        assert len(stamps) > 1
