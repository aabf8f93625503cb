"""The port's PLY export against the JAX package on the CPU.

* ``write_ply_vertices`` writes the JAX package's bytes for the same dict
  (float32, float64 cast to float32, uint8, int32; binary and ascii), and
  each package reads the other's file to the same arrays (ascii: to its 8
  significant digits).
* ``BasicPointCloud.save_ply`` / ``from_ply`` round-trip (positions,
  normals, colours quantised to uint8) and swap with JAX's.
* ``get_ply_dict`` of a model holding JAX's parameters equals JAX's, key
  for key and bit for bit, in the standard 3DGS property order.
"""

import numpy as np
import pytest
import torch

from nerficg_torch.core.config import ConfigNode as TConfig
from nerficg_torch.data import ply as tply
from nerficg_torch.data.types import BasicPointCloud as TCloud
from nerficg_torch.methods.gaussian_splatting.model import \
    GaussianSplattingModel as TModel
from nerficg_tpu.core.config import ConfigNode as JConfig
from nerficg_tpu.data import ply as jply
from nerficg_tpu.data.types import BasicPointCloud as JCloud
from nerficg_tpu.methods.gaussian_splatting.model import \
    GaussianSplattingModel as JModel
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _props(n=257, seed=0):
    rng = np.random.default_rng(seed)
    return {'x': rng.normal(size=n).astype(np.float32),
            'y': rng.normal(size=n),                        # float64 -> f4
            'z': rng.normal(size=n).astype(np.float32),
            'red': rng.integers(0, 256, n).astype(np.uint8),
            'label': rng.integers(-5, 5, n).astype(np.int32),
            'opacity': rng.normal(size=n).astype(np.float32)}


@pytest.mark.parametrize('ascii_format', [False, True],
                         ids=['binary', 'ascii'])
def test_write_ply_vertices_byte_identical(tmp_path, ascii_format):
    props = _props()
    tply.write_ply_vertices(props, tmp_path / 't.ply', ascii_format)
    jply.write_ply_vertices(props, tmp_path / 'j.ply', ascii_format)
    assert (tmp_path / 't.ply').read_bytes() == \
        (tmp_path / 'j.ply').read_bytes()
    for reader in (tply.read_ply_vertices, jply.read_ply_vertices):
        for name in ('t.ply', 'j.ply'):
            back = reader(tmp_path / name)
            assert list(back) == list(props)
            for key, value in props.items():
                want = value.astype(np.float32) \
                    if value.dtype == np.float64 else value
                assert back[key].dtype == want.dtype, key
                if ascii_format:        # '%.8g': 8 significant digits
                    np.testing.assert_allclose(back[key], want, rtol=2 ** -22,
                                               err_msg=key)
                else:
                    assert np.array_equal(back[key], want), key


def test_point_cloud_round_trip_and_swap(tmp_path):
    rng = np.random.default_rng(1)
    pos = rng.normal(size=(300, 3)).astype(np.float32)
    nrm = rng.normal(size=(300, 3)).astype(np.float32)
    col = rng.random((300, 3)).astype(np.float32)
    TCloud(pos, col, nrm).save_ply(tmp_path / 't.ply')
    JCloud(pos, col, nrm).save_ply(tmp_path / 'j.ply')
    assert (tmp_path / 't.ply').read_bytes() == \
        (tmp_path / 'j.ply').read_bytes()
    back = TCloud.from_ply(tmp_path / 'j.ply')
    other = JCloud.from_ply(tmp_path / 't.ply')
    assert np.array_equal(back.positions, pos)
    assert np.array_equal(back.normals, nrm)
    assert np.array_equal(back.colors,
                          (np.clip(col, 0, 1) * 255).astype(np.uint8)
                          .astype(np.float32) / 255)
    for key in ('positions', 'colors', 'normals'):
        assert np.array_equal(getattr(back, key), getattr(other, key)), key
    TCloud(pos).save_ply(tmp_path / 'bare.ply')
    bare = TCloud.from_ply(tmp_path / 'bare.ply')
    assert bare.colors is None and bare.normals is None
    assert np.array_equal(bare.positions, pos)


def test_get_ply_dict_matches_jax(tmp_path):
    """JAX's parameters (SH_DEGREE 4: 16 coefficients; 1000 of 1024 rows
    active; random values in every group) carried into the port's model:
    the same dict, keys in the same order, values bit-equal; the files
    written from both are byte-identical."""
    cfg = {'MODEL': {'SH_DEGREE': 4, 'CAPACITY_GRANULARITY': 1024}}
    rng = np.random.default_rng(2)
    pos = rng.normal(size=(1000, 3)).astype(np.float32)
    j = JModel(JConfig(cfg))
    j.init_from_point_cloud(JCloud(pos, rng.random((1000, 3))))
    params = {k: rng.normal(size=np.asarray(v).shape).astype(np.float32)
              for k, v in j.params.items()}
    j.params = {k: v for k, v in params.items()}
    t = TModel(TConfig(cfg), device='cpu')
    t.init_from_point_cloud(TCloud(pos, rng.random((1000, 3))))
    t.load_params_tree(params)
    got, want = t.get_ply_dict(), j.get_ply_dict()
    assert list(got) == list(want)
    assert len(got) == 3 + 3 + 3 + 45 + 1 + 3 + 4
    for key in want:
        assert got[key].dtype == np.asarray(want[key]).dtype, key
        assert np.array_equal(got[key], np.asarray(want[key])), key
    assert len(got['x']) == 1000
    tply.write_ply_vertices(got, tmp_path / 't.ply')
    jply.write_ply_vertices(want, tmp_path / 'j.ply')
    assert (tmp_path / 't.ply').read_bytes() == \
        (tmp_path / 'j.ply').read_bytes()
    assert isinstance(t.params['positions'], torch.nn.Parameter)
