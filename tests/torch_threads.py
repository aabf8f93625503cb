"""Autouse fixture for the port's CPU tests: one torch intra-op thread.

The suite runs in several worker processes at once on a few cores; torch's
default of one intra-op thread per core in every worker oversubscribes them,
and the port's many small tensor ops then spend their time in thread
hand-offs (the port's tests took ten times longer that way). Import
``one_torch_thread`` into a test module to run its tests single-threaded.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
