"""The port's ``create_config`` against the JAX package's on the CPU.

For every (method, dataset) pair the port registers, ``build_config`` gives
JAX's config as a dict, and the YAML files both scripts write parse to the
same dict; with -a, one config per scene directory, as JAX writes them.
"""

import importlib.util
import sys
from pathlib import Path

import pytest
import yaml

from nerficg_torch.core.logging import Logger as TLogger
from nerficg_torch.core.registry import Datasets as TDatasets
from nerficg_torch.core.registry import Methods as TMethods
from nerficg_torch.scripts import create_config as tcreate
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TLogger.set_level('SILENT')

_SCRIPT = Path(__file__).resolve().parent.parent / 'scripts' / \
    'create_config.py'


def _jax_script():
    spec = importlib.util.spec_from_file_location('jax_create_config',
                                                  _SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# Mip-NeRF 360 is the port's alone: the JAX package has no such method.
PORT_ONLY = ['MipNeRF360']
PAIRS = [(m, d) for m in TMethods.options() if m not in PORT_ONLY
         for d in TDatasets.options()]


def test_the_port_registers_what_it_should():
    assert TMethods.options() == ['DNeRF', 'GaussianSplatting',
                                  'InstantNGP', 'MipNeRF360', 'NeRF']
    assert TDatasets.options() == ['Colmap', 'DNeRF', 'Empty',
                                   'MipNeRF360', 'NeRF', 'NvidiaShort',
                                   'OmniBlender', 'PlenopticVideoBlender',
                                   'RTMV', 'RaRPano', 'Ricoh360',
                                   'TanksAndTemples', 'TanksAndTemples_3DGS']


@pytest.mark.parametrize('method,dataset', PAIRS)
def test_build_config_matches_jax(method, dataset, tmp_path, monkeypatch):
    jax_script = _jax_script()
    got = tcreate.build_config(method, dataset, '/data/scene')
    want = jax_script.build_config(method, dataset, '/data/scene')
    assert got.to_dict() == want.to_dict()
    tcreate.main(['-m', method, '-d', dataset, '-o', str(tmp_path / 't.yaml'),
                  '-p', '/data/scene'])
    monkeypatch.setattr(sys, 'argv', [
        'create_config.py', '-m', method, '-d', dataset, '-o',
        str(tmp_path / 'j.yaml'), '-p', '/data/scene'])
    jax_script.main()
    t_text = (tmp_path / 't.yaml').read_text()
    j_text = (tmp_path / 'j.yaml').read_text()
    assert yaml.safe_load(t_text) == yaml.safe_load(j_text)


@pytest.mark.parametrize('method', PORT_ONLY)
def test_build_config_of_a_method_only_the_port_has(method, tmp_path):
    """The written config holds the method's own defaults, as a JAX
    method's does, and the dataset's."""
    entry = TMethods.get_entry(method)
    tcreate.main(['-m', method, '-d', 'MipNeRF360', '-o',
                  str(tmp_path / 't.yaml'), '-p', '/data/scene'])
    config = yaml.safe_load((tmp_path / 't.yaml').read_text())
    assert config['GLOBAL']['METHOD_TYPE'] == method
    assert config['DATASET']['PATH'] == '/data/scene'
    for section, cls in (('MODEL', entry.model_cls),
                         ('RENDERER', entry.renderer_cls),
                         ('TRAINING', entry.trainer_cls)):
        assert config[section] == cls.default_parameters()


def test_all_scenes_matches_jax(tmp_path, monkeypatch):
    """-a: one config per scene subdirectory, as JAX writes them."""
    for scene in ('garden', 'bicycle', 'stump'):
        (tmp_path / 'scenes' / scene).mkdir(parents=True)
    (tmp_path / 'scenes' / 'notes.txt').write_text('not a scene')
    written = tcreate.main(['-m', 'GaussianSplatting', '-d', 'MipNeRF360',
                            '-o', str(tmp_path / 't' / 'm360.yaml'), '-p',
                            str(tmp_path / 'scenes'), '-a'])
    monkeypatch.setattr(sys, 'argv', [
        'create_config.py', '-m', 'GaussianSplatting', '-d', 'MipNeRF360',
        '-o', str(tmp_path / 'j' / 'm360.yaml'), '-p',
        str(tmp_path / 'scenes'), '-a'])
    _jax_script().main()
    assert [p.name for p in written] == ['bicycle.yaml', 'garden.yaml',
                                         'stump.yaml']
    for path in written:
        assert path.parent == tmp_path / 't' / 'm360'
        config = yaml.safe_load(path.read_text())
        assert config == yaml.safe_load(
            (tmp_path / 'j' / 'm360' / path.name).read_text())
        assert config['DATASET']['PATH'] == \
            str(tmp_path / 'scenes' / path.stem)
        assert config['DATASET']['DOWNSAMPLE'] == 4
        assert config['MODEL']['SH_DEGREE'] == 4


def test_setup_refuses_anomaly_detection():
    """The port carries the JAX package's global keys but does not port
    ANOMALY_DETECTION (jax_debug_nans): setting it raises."""
    from nerficg_torch.core.config import ConfigNode, default_global_config
    from nerficg_torch.core.errors import ConfigError
    from nerficg_torch.core.setup import setup
    config = ConfigNode({'GLOBAL': default_global_config()})
    assert setup(config=config, device='cpu').device.type == 'cpu'
    config.GLOBAL.ANOMALY_DETECTION = True
    with pytest.raises(ConfigError):
        setup(config=config, device='cpu')
