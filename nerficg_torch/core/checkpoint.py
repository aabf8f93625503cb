"""Checkpoint save / load of parameter trees + metadata.

Port of nerficg_tpu/core/checkpoint.py with the same on-disk format, so a
checkpoint written by either package loads in the other. A ``.ckpt`` file is
an ``npz`` archive (zip of raw ``.npy`` arrays, no pickle) holding
  * ``__meta__``       : JSON string {'format_version', 'metadata', 'tree_names'}
  * ``params/<path>``  : one entry per leaf of the param tree
  * ``extra/<name>/<path>`` : leaves of each extra tree (buffers, ...)
Trees are nested dicts and lists of numpy arrays or tensors; paths join dict
keys (in sorted order, as the JAX tree walk visits them) and list indices
with '/', e.g. ``params/hash_table``, ``params/density_mlp/0``,
``extra/buffers/density_grid``.
"""

from __future__ import annotations

import io
import json
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch

from nerficg_torch.core.errors import CheckpointError

__all__ = ['save_checkpoint', 'load_checkpoint', 'flatten_tree', 'unflatten_tree']

FORMAT_VERSION = 2


def _walk(tree: Any, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _walk(tree[key], prefix + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _walk(value, prefix + (str(i),))
    elif tree is not None:
        yield prefix, tree


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def flatten_tree(tree: Any) -> dict[str, np.ndarray]:
    """Tree of dicts/lists -> {'a/b/0': array} flat dict of host numpy arrays."""
    return {'/'.join(path): _to_numpy(leaf) for path, leaf in _walk(tree)}


def unflatten_tree(flat: dict[str, np.ndarray]):
    """Inverse of flatten_tree: rebuild nested dicts, then turn any dict whose
    keys are exactly '0'..'n-1' back into a list. A single ''-keyed entry
    denotes a bare-array tree."""
    if set(flat) == {''}:
        return flat['']
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split('/')
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node) and \
                sorted(int(k) for k in node) == list(range(len(node))):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(tree)


def save_checkpoint(path: str | Path, params: Any, metadata: dict | None = None,
                    extra_trees: dict[str, Any] | None = None) -> None:
    """Save a param tree (+ optional extra trees). ``metadata`` must be
    JSON-serializable."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    trees = {'params': params}
    for name, tree in (extra_trees or {}).items():
        trees[f'extra/{name}'] = tree
    arrays: dict[str, np.ndarray] = {}
    for prefix, tree in trees.items():
        for key, arr in flatten_tree(tree).items():
            arrays[f'{prefix}/{key}' if key else prefix] = arr
    meta = {'format_version': FORMAT_VERSION,
            'metadata': metadata or {},
            'tree_names': sorted(trees)}
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.asarray(json.dumps(meta)), **arrays)
    tmp = path.with_suffix(path.suffix + '.tmp')
    tmp.write_bytes(buf.getvalue())
    tmp.replace(path)


def load_checkpoint(path: str | Path) -> dict:
    """Load a checkpoint dict {'params', 'metadata', 'extra'} of numpy trees.

    Safe for untrusted files: a plain npz archive read with
    ``allow_pickle=False``; metadata is JSON."""
    path = Path(path)
    if not path.is_file():
        raise CheckpointError(f'checkpoint not found: {path}')
    try:
        with np.load(path, allow_pickle=False) as z:
            if '__meta__' not in z.files:
                raise CheckpointError(
                    f'{path} is not a nerficg checkpoint (no __meta__)')
            meta = json.loads(str(z['__meta__']))
            arrays = {k: z[k] for k in z.files if k != '__meta__'}
    except CheckpointError:
        raise
    except (OSError, ValueError) as e:  # zip/format errors from np.load
        raise CheckpointError(f'failed to read checkpoint {path}: {e}')
    if meta.get('format_version') != FORMAT_VERSION:
        raise CheckpointError(f'unsupported checkpoint version in {path}')

    def tree_of(prefix: str):
        plen = len(prefix) + 1
        flat = {k[plen:] if len(k) > len(prefix) else '': v
                for k, v in arrays.items()
                if k == prefix or k.startswith(prefix + '/')}
        return unflatten_tree(flat) if flat else {}

    extra = {}
    for name in meta.get('tree_names', []):
        if name.startswith('extra/'):
            extra[name[len('extra/'):]] = tree_of(name)
    return {'params': tree_of('params'), 'metadata': meta['metadata'],
            'extra': extra}
