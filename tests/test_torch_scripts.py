"""The port's offline tools (``nerficg_torch/scripts/``) against the JAX
package's scripts (``scripts/``) on the CPU, each through its ``main(argv)``
with ``--device cpu`` where it has one.

* ``generate_tables`` on a written root/scene/method tree with masks and
  the LPIPS weights file: every row's values within TABLE_ATOL of the JAX
  script's, and its file to the last printed digit: the rows the JAX
  script writes, then the LaTeX tabular it means to write (its -o raises
  after the rows, a fault of the JAX script the port does not copy).
* ``benchmark_sweep`` over two 16x16 scenes and ``sequential_train`` over
  one of its configs, each run a ``python -m nerficg_torch.scripts.train``
  child of NeRF at a small width for 10 iterations: the summaries in the
  JAX scripts' layout, built by the JAX scripts' own parsers from the
  port's run files, with a finite LPIPS in each run's metrics.
* ``cutie --backend median``: masks bit-equal to the JAX script's on
  written frames.
* ``colmap`` against a stand-in ``colmap`` on PATH that logs its argv: the
  JAX script's command sequence.
* The refusals, each exit 1: ``colmap`` missing or no images/, the Cutie
  command missing, torchvision missing (and RAFT's weights not cached),
  MiDaS not in torch hub's cache, and ``install`` without a card (with
  ``--device cpu`` it passes).
"""

import importlib.util
import math
import os
import re
import stat
import sys
import types
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from nerficg_torch.data.synthetic import make_synthetic_scene
from nerficg_torch.scripts import (benchmark_sweep, colmap, cutie,
                                   generate_tables, install,
                                   monocular_depth, raft, sequential_train)
from test_torch_lpips import npz, with_weights  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
# The two packages' metrics agree to test_torch_lpips.METRIC_ATOL.
TABLE_ATOL = 1e-4


def _jax_script(name):
    """The JAX package's ``scripts/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f'jax_script_{name}', REPO / 'scripts' / f'{name}.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax_main(module, monkeypatch, argv):
    monkeypatch.setattr(sys, 'argv', [module.__file__, *argv])
    return module.main()


# -- generate_tables ---------------------------------------------------------

def _png(path, array):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(array).save(path)


@pytest.fixture(scope='module')
def table_tree(tmp_path_factory):
    """root/<scene>/{gt, masks, <methods>}: 26x22 images; a method missing
    one image, an image without ground truth, a scene without gt/."""
    root = tmp_path_factory.mktemp('tables')
    rng = np.random.default_rng(0)
    ys, xs = np.mgrid[0:22, 0:26]
    for scene, methods in (('bicycle', ('InstantNGP', 'NeRF')),
                           ('lego', ('InstantNGP',))):
        for k in range(3):
            gt = (rng.random((22, 26, 3)) * 255).astype(np.uint8)
            _png(root / scene / 'gt' / f'{k:05d}.png', gt)
            mask = ((ys - 11) ** 2 + (xs - 9 - 3 * k) ** 2 < 40)
            _png(root / scene / 'masks' / f'{k:05d}.png',
                 (mask * 255).astype(np.uint8))
            for m, method in enumerate(methods):
                if (scene, method, k) == ('bicycle', 'NeRF', 2):
                    continue
                noise = rng.normal(0, 10 + 10 * m, gt.shape)
                _png(root / scene / method / f'{k:05d}.png',
                     np.clip(gt + noise, 0, 255).astype(np.uint8))
        _png(root / scene / methods[0] / '00009.png',
             np.zeros((22, 26, 3), np.uint8))
    _png(root / 'no_gt' / 'InstantNGP' / '00000.png',
         np.zeros((22, 26, 3), np.uint8))
    return root


_NUMBER = re.compile(r'-?\d+\.\d+|nan')


def _numbers(line):
    return [float(t) for t in _NUMBER.findall(line)]


def test_generate_tables_matches_jax(table_tree, tmp_path, monkeypatch,
                                     with_weights):
    jax_script = _jax_script('generate_tables')
    rows = generate_tables.main(['-r', str(table_tree), '-m', 'masks',
                                 '-o', str(tmp_path / 'port.txt'),
                                 '--device', 'cpu'])
    # The JAX script's -o writes the rows, then stops: its '% LaTeX' line
    # goes through %-formatting ('% La' is a directive) and raises.
    with pytest.raises(TypeError, match='not enough arguments'):
        _run_jax_main(jax_script, monkeypatch,
                      ['-r', str(table_tree), '-m', 'masks',
                       '-o', str(tmp_path / 'jax.txt')])
    assert [(s, m) for s, m, _ in rows] == [
        ('bicycle', 'InstantNGP'), ('bicycle', 'NeRF'), ('lego', 'InstantNGP')]
    latex = ['', '% LaTeX', '\\begin{tabular}{llcccccc}']
    for scene, method, metrics in rows:
        want = jax_script.evaluate_dir(table_tree / scene / method,
                                       table_tree / scene / 'gt',
                                       table_tree / scene / 'masks')
        latex.append(f'{scene} & {method} & ' +
                     ' & '.join(f'{v:.3f}' for v in want.values()) + ' \\\\')
        assert list(metrics) == list(want) == [
            'PSNR', 'SSIM', 'LPIPS', 'mPSNR', 'mSSIM', 'mLPIPS']
        for key, value in want.items():
            assert math.isfinite(metrics[key])
            assert metrics[key] == pytest.approx(value, abs=TABLE_ATOL), \
                (scene, method, key)
    got = (tmp_path / 'port.txt').read_text().splitlines()
    want = (tmp_path / 'jax.txt').read_text().splitlines() + latex + \
        ['\\end{tabular}']
    assert len(got) == len(want) == 3 + 4 + 3
    for g, w in zip(got, want):
        # Names and keys equal; each number to its last printed digit
        # (4 decimals in the rows, 3 in the LaTeX).
        assert _NUMBER.sub('#', g) == _NUMBER.sub('#', w)
        digits = 4 if '=' in g else 3
        np.testing.assert_allclose(_numbers(g), _numbers(w), rtol=0,
                                   atol=1.01 * 10.0 ** -digits)


# -- the dataset sweep and sequential training ------------------------------

SMALL_NERF = ['MODEL.NUM_LAYERS=2', 'MODEL.WIDTH=32', 'MODEL.SKIP_LAYER=1',
              'RENDERER.N_SAMPLES=16', 'TRAINING.RAYS_PER_BATCH=64',
              'TRAINING.NUM_ITERATIONS=10', 'GLOBAL.LOG_LEVEL=SILENT']


@pytest.fixture(scope='module')
def sweep_run(tmp_path_factory, npz):  # noqa: F811
    """The port's sweep of NeRF over two 16x16 blob scenes, run from its
    own working directory with the LPIPS weights, and sequential_train of
    the first scene's config with the same settings written in."""
    from nerficg_torch.core.config import load_config, save_config
    work = tmp_path_factory.mktemp('sweep')
    data = work / 'data'
    for scene in ('blob_a', 'blob_b'):
        make_synthetic_scene(data / scene, image_size=16, n_train=4,
                             n_test=2)
    monkeypatch = pytest.MonkeyPatch()
    monkeypatch.setenv('NERFICG_LPIPS_WEIGHTS', str(npz))
    monkeypatch.chdir(work)
    try:
        rows = benchmark_sweep.main(['-m', 'NeRF', '-d', 'NeRF', '-p',
                                     str(data), '-o', 'output/benchmark',
                                     '--device', 'cpu', *SMALL_NERF])
        config = work / 'sequential.yaml'
        save_config(load_config(work / 'output' / 'benchmark' / 'blob_a.yaml',
                                SMALL_NERF + ['TRAINING.MODEL_NAME=sequential']),
                    config)
        results = sequential_train.main([str(config), '-o',
                                         'output/summary.txt',
                                         '--device', 'cpu'])
    finally:
        monkeypatch.undo()
    return work, rows, results


def test_benchmark_sweep_summary_as_jax(sweep_run):
    work, rows, _ = sweep_run
    jax_script = _jax_script('benchmark')
    assert benchmark_sweep.SCENE_OVERRIDES == jax_script.SCENE_OVERRIDES
    assert [scene for scene, _ in rows] == ['blob_a', 'blob_b']
    lines, latex = [], ['\\begin{tabular}{lccc}',
                        'scene & metrics & time & memory \\\\']
    for scene, info in rows:
        run_dirs = sorted((work / 'output' / 'NeRFModel').glob(f'{scene}_*'))
        assert len(run_dirs) == 1
        want = jax_script.parse_run_files(run_dirs[0])
        assert info == want
        assert want['metrics'].startswith('mean: PSNR=')
        lpips = float(want['metrics'].split('LPIPS=')[1].split()[0])
        assert math.isfinite(lpips) and lpips > 0
        assert want['time'] != 'n/a' and want['memory'] != 'n/a'
        lines.append(f'{scene}: {want["metrics"]} | time {want["time"]} | '
                     f'{want["memory"]}')
        latex.append(f'{scene} & {want["metrics"]} & {want["time"]} & '
                     f'{want["memory"]} \\\\')
    latex.append('\\end{tabular}')
    out = work / 'output' / 'benchmark'
    assert (out / 'summary.txt').read_text().splitlines() == lines
    assert (out / 'latex_tables.txt').read_text().splitlines() == latex


def test_sequential_train_summary_as_jax(sweep_run):
    work, _, results = sweep_run
    jax_script = _jax_script('sequential_train')
    run_dir = jax_script.latest_run_dir(work / 'output')
    assert run_dir.name.startswith('sequential_')
    config = str(work / 'sequential.yaml')
    want = f'{config}: {jax_script.parse_metrics_line(run_dir)}'
    assert results == [(config, jax_script.parse_metrics_line(run_dir))]
    assert (work / 'output' / 'summary.txt').read_text() == want + '\n'
    assert 'LPIPS=' in want


def test_sequential_train_failure(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    missing = str(tmp_path / 'missing.yaml')
    results = sequential_train.main([missing, missing, '--device', 'cpu'])
    assert len(results) == 1 and results[0][1].startswith('FAILED (exit ')
    assert (tmp_path / 'output' / 'summary.txt').read_text().startswith(
        f'{missing}: FAILED')


# -- cutie -----------------------------------------------------------------------

def test_cutie_median_masks_equal_jax(tmp_path):
    jax_script = _jax_script('cutie')
    rng = np.random.default_rng(5)
    background = (rng.random((20, 28, 3)) * 255).astype(np.uint8)
    for k in range(6):
        frame = background.copy()
        frame[4:10, 2 + 4 * k:8 + 4 * k] = [250, 20, 20]
        frame[15, 27] = 0                           # one pixel at the border
        _png(tmp_path / 'scene' / 'images' / f'{k:04d}.png', frame)
    images = tmp_path / 'scene' / 'images'
    assert cutie.median_masks(images, tmp_path / 'port', 0.08, 2) == 6
    assert jax_script.median_masks(images, tmp_path / 'jax', 0.08, 2) == 6
    for k in range(6):
        got = np.asarray(Image.open(tmp_path / 'port' / f'{k:04d}.png'))
        want = np.asarray(Image.open(tmp_path / 'jax' / f'{k:04d}.png'))
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert 0 < (got > 0).mean() < 0.5
    assert cutie.main(['-p', str(tmp_path / 'scene'), '--dilate', '0']) == 6


def test_cutie_cli_missing_refused(tmp_path):
    with pytest.raises(SystemExit) as exc:
        cutie.main(['-p', str(tmp_path), '--backend', 'cutie',
                    '--cutie-cmd', 'no-such-cutie-command'])
    assert exc.value.code == 1


# -- colmap --------------------------------------------------------------------

@pytest.fixture
def fake_colmap(tmp_path, monkeypatch):
    """A ``colmap`` on PATH that appends its argv to a log; returns the
    log's path."""
    bin_dir = tmp_path / 'bin'
    bin_dir.mkdir()
    log = tmp_path / 'colmap.log'
    script = bin_dir / 'colmap'
    script.write_text(f'#!/bin/sh\necho "$@" >> {log}\n')
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv('PATH', f'{bin_dir}{os.pathsep}{os.environ["PATH"]}')
    return log


@pytest.mark.parametrize('extra', [[], ['--matcher', 'sequential',
                                        '--undistort', '--gpu']])
def test_colmap_commands_as_jax(tmp_path, monkeypatch, fake_colmap, extra):
    jax_script = _jax_script('colmap')
    scene = tmp_path / 'scene'
    (scene / 'images').mkdir(parents=True)
    argv = ['-p', str(scene), *extra]
    assert colmap.main(argv) == scene
    got = fake_colmap.read_text()
    fake_colmap.unlink()
    _run_jax_main(jax_script, monkeypatch, argv)
    want = fake_colmap.read_text()
    assert got == want
    assert len(got.splitlines()) == 5 + ('--undistort' in extra)


def test_colmap_refusals(tmp_path, monkeypatch, fake_colmap):
    with pytest.raises(SystemExit) as exc:                # no images/
        colmap.main(['-p', str(tmp_path / 'scene')])
    assert exc.value.code == 1
    monkeypatch.setenv('PATH', str(tmp_path / 'empty'))  # no colmap
    (tmp_path / 'scene' / 'images').mkdir(parents=True)
    with pytest.raises(SystemExit) as exc:
        colmap.main(['-p', str(tmp_path / 'scene')])
    assert exc.value.code == 1
    assert not fake_colmap.exists()


# -- raft, monocular depth, install --------------------------------------------

def test_raft_refuses_without_torchvision(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'torchvision', None)
    with pytest.raises(SystemExit) as exc:
        raft.main(['-p', str(tmp_path), '--device', 'cpu'])
    assert exc.value.code == 1


def test_raft_refuses_without_cached_weights(tmp_path, monkeypatch):
    """torchvision present, its RAFT weights not in torch hub's cache:
    refused before the model (which would download them) is built."""
    built = []
    weights = types.SimpleNamespace(
        url='https://download.example/raft_small_C_T_V2-01064c6d.pth')
    flow = types.ModuleType('torchvision.models.optical_flow')
    flow.Raft_Small_Weights = types.SimpleNamespace(DEFAULT=weights)
    flow.raft_small = lambda **kwargs: built.append(kwargs)
    for name, module in (('torchvision', types.ModuleType('torchvision')),
                         ('torchvision.models',
                          types.ModuleType('torchvision.models')),
                         ('torchvision.models.optical_flow', flow)):
        monkeypatch.setitem(sys.modules, name, module)
    monkeypatch.setenv('TORCH_HOME', str(tmp_path / 'torch_home'))
    assert raft.cached_weights(weights.url) == \
        tmp_path / 'torch_home' / 'hub' / 'checkpoints' / \
        'raft_small_C_T_V2-01064c6d.pth'
    with pytest.raises(SystemExit) as exc:
        raft.main(['-p', str(tmp_path), '--device', 'cpu'])
    assert exc.value.code == 1 and not built


def test_monocular_depth_refuses_without_midas(tmp_path, monkeypatch):
    monkeypatch.setenv('TORCH_HOME', str(tmp_path / 'torch_home'))
    with pytest.raises(FileNotFoundError, match='hubconf.py'):
        monocular_depth.load_midas()
    with pytest.raises(SystemExit) as exc:
        monocular_depth.main(['-p', str(tmp_path), '--device', 'cpu'])
    assert exc.value.code == 1


def test_entry_points_refuse_without_a_card(tmp_path):
    """Without ``--device cpu`` each tool that computes on the card
    refuses on a machine without one."""
    import torch
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: nothing to refuse')
    from nerficg_torch.core.errors import KernelError
    for main, argv in ((raft.main, ['-p', str(tmp_path)]),
                       (monocular_depth.main, ['-p', str(tmp_path)]),
                       (generate_tables.main, ['-r', str(tmp_path)])):
        with pytest.raises(KernelError, match='--device cpu'):
            main(argv)


def test_install_doctor(capsys, monkeypatch):
    import torch

    from nerficg_torch.core.logging import Logger
    monkeypatch.setattr(Logger, 'level', Logger.NORMAL)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as exc:
            install.main([])
        assert exc.value.code == 1
        assert 'no CUDA card is available' in capsys.readouterr().err
    assert install.main(['--device', 'cpu']) == 0
    err = capsys.readouterr().err
    assert 'method GaussianSplatting: model=' in err
    assert '13 dataset loaders importable' in err
    assert 'optional LPIPS weights' in err and 'environment OK' in err
