"""The benchmark's own tests. ``cuda`` marks a test that needs a card; it
skips inside its fixture where there is none. Run them from the root of a
checkout: ``python -m pytest nerfbench/tests -q`` (on the card machine
too: this file imports neither JAX nor the JAX package)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: runs a cell of the benchmark on a CUDA card; '
        'skipped where torch.cuda.is_available() is false')


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('no CUDA card: the cell runs on the card only')
    return 'cuda'
