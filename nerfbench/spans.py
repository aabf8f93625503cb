"""Layer ranges around the calls into the program, for traced runs.

``nerfbench/spans/<METHOD_TYPE>.json`` lists, per method, the program's
functions that begin a layer (``"module:Attribute"`` or
``"module:Class.method"``) and the layer's name. ``install`` wraps each in
a ``torch.profiler.record_function`` range named ``nerfbench/<layer>``
and returns a function that puts the originals back. Only ``--trace 1``
runs install them; a run with ``--trace 0`` measures the program as it is.
"""

from __future__ import annotations

import functools
import importlib
import json
from pathlib import Path

__all__ = ['load', 'install']

_DIR = Path(__file__).resolve().parent / 'spans'


def load(method: str) -> list[dict]:
    path = _DIR / f'{method}.json'
    return json.loads(path.read_text())['spans'] if path.is_file() else []


def _wrap(fn, label: str):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    return wrapper


def install(method: str):
    """Wrap the method's layer entries; returns the undo function."""
    from nerfbench.trace import SPAN_PREFIX
    undo = []
    for entry in load(method):
        module_name, attr = entry['target'].split(':')
        owner = importlib.import_module(module_name)
        *path, name = attr.split('.')
        for part in path:
            owner = getattr(owner, part)
        original = owner.__dict__[name] if isinstance(owner, type) else \
            getattr(owner, name)
        setattr(owner, name, _wrap(original, SPAN_PREFIX + entry['layer']))
        undo.append((owner, name, original))

    def restore():
        for owner, name, original in reversed(undo):
            setattr(owner, name, original)
    return restore
