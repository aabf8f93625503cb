"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), the
reference imports nothing of the program, and without a card, or with a
module of JAX loaded after the window, a run prints no result."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from nerfbench import run
from nerfbench.run import FORBIDDEN
from nerfbench.spec import HERE, ROOT


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


def test_no_file_of_the_benchmark_imports_jax():
    for path in HERE.rglob('*.py'):
        assert not _imports(path) & set(FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / 'reference').rglob('*.py'):
        assert 'nerficg_torch' not in _imports(path), path


def test_a_run_loads_no_jax_module():
    code = ('import sys; sys.path.insert(0, "nerfbench/tests");'
            'from tiny import tiny_cell;'
            'from nerfbench.run import run_cell, forbidden_modules;'
            'r = run_cell(tiny_cell("gs360_train"), 3, 0.2, True,'
            ' device="cpu", start=0.0);'
            'import json; print(json.dumps([r["correct"],'
            ' forbidden_modules(), sorted({m.split(".")[0]'
            ' for m in sys.modules})]))')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, forbidden, loaded = json.loads(out.stdout.splitlines()[-1])
    assert correct and forbidden == []
    assert 'nerficg_torch' in loaded and 'nerficg_tpu' not in loaded


def test_without_a_card_no_result(tmp_path):
    """Here there is no card: exit 2, nothing on standard output."""
    out = subprocess.run([sys.executable, '-m', 'nerfbench.run',
                          '--workload', 'gs360_train', '--seed', '1',
                          '--seconds', '1', '--trace', '0'], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 2 and out.stdout == ''


@pytest.mark.parametrize('loads_jax', [False, True],
                         ids=['sound_reader', 'reader_loads_jax'])
def test_jax_loaded_after_the_window_gives_no_result(tmp_path, monkeypatch,
                                                     capsys, loads_jax):
    """A per-layer metric's reader, found by name after the window, that
    loads a module named ``jax`` (a stub on the path): the run prints no
    result and exits with another code than 0; the same run with a sound
    reader prints its result."""
    from tiny import tiny_cell
    stub = tmp_path / 'stub' / 'jax'
    stub.mkdir(parents=True)
    (stub / '__init__.py').write_text('')
    monkeypatch.syspath_prepend(str(stub.parent))
    here = tmp_path / 'nerfbench'
    shutil.copytree(HERE / 'metrics', here / 'metrics')
    (here / 'metrics' / 'probe.train.py').write_text(
        ('import jax  # noqa: F401\n' if loads_jax else '') +
        'def read(ctx):\n    return 1.0\n')
    cell = tiny_cell('gs360_train')
    cell.here = here
    cell.per_layer = [{'name': 'probe.train', 'unit': '%',
                       'moves': 'train_it_per_s'}]
    real = run.run_cell
    monkeypatch.setattr(run, '_cache_dirs', lambda: None)
    monkeypatch.setattr(run, 'cuda_cards', lambda: 1)
    monkeypatch.setattr(run, 'run_cell', lambda *a, **k: real(
        cell, 3, 0.2, True, device='cpu', start=0.0))
    try:
        code = run.main(['--workload', 'gs360_train', '--seed', '3',
                         '--seconds', '0.2', '--trace', '1'])
        loaded = 'jax' in sys.modules
    finally:
        sys.modules.pop('jax', None)
    out, err = capsys.readouterr()
    assert loaded == loads_jax
    if loads_jax:
        assert code != 0 and out == '' and "['jax']" in err
    else:
        assert code == 0
        result = json.loads(out.splitlines()[-1])
        assert result['metrics']['probe.train']['value'] == 1.0
