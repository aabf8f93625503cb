"""Minimal PLY reader/writer (binary little-endian + ascii), a port of
nerficg_tpu/data/ply.py.

It stands in for the reference's ``plyfile`` dependency (reference:
scripts/convert_to_ply.py:18-44, Datasets/utils.py:300-403's from_ply) and
writes the same bytes as the JAX package for the same dict: the header, the
property order and binary little-endian float32. Vertex layouts: point
clouds and 3DGS exports.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

__all__ = ['read_ply_vertices', 'write_ply_vertices',
           'read_ply_pointcloud', 'write_ply_pointcloud']

_DTYPES = {
    'char': 'i1', 'int8': 'i1', 'uchar': 'u1', 'uint8': 'u1',
    'short': 'i2', 'int16': 'i2', 'ushort': 'u2', 'uint16': 'u2',
    'int': 'i4', 'int32': 'i4', 'uint': 'u4', 'uint32': 'u4',
    'float': 'f4', 'float32': 'f4', 'double': 'f8', 'float64': 'f8',
}
_DTYPE_NAMES = {'i1': 'char', 'u1': 'uchar', 'i2': 'short', 'u2': 'ushort',
                'i4': 'int', 'u4': 'uint', 'f4': 'float', 'f8': 'double'}


def read_ply_vertices(path: str | Path) -> dict[str, np.ndarray]:
    """Read the 'vertex' element -> dict of {property_name: (N,) array}."""
    with open(path, 'rb') as f:
        if f.readline().strip() != b'ply':
            raise ValueError(f'{path}: not a PLY file')
        fmt = None
        elements: list[tuple[str, int, list[tuple[str, str]]]] = []
        props: list[tuple[str, str]] = []
        while True:
            line = f.readline().strip().decode('ascii')
            if line.startswith('comment'):
                continue
            if line.startswith('format'):
                fmt = line.split()[1]
            elif line.startswith('element'):
                _, name, count = line.split()
                props = []
                elements.append((name, int(count), props))
            elif line.startswith('property'):
                parts = line.split()
                if parts[1] == 'list':
                    props.append((parts[-1], f'list:{parts[2]}:{parts[3]}'))
                else:
                    props.append((parts[-1], _DTYPES[parts[1]]))
            elif line == 'end_header':
                break
        result: dict[str, np.ndarray] = {}
        for name, count, elem_props in elements:
            if any(t.startswith('list:') for _, t in elem_props):
                if name == 'vertex':
                    raise ValueError('list properties on vertex element unsupported')
                break  # face lists etc. after vertex data: stop (vertex read done)
            if fmt == 'ascii':
                rows = [f.readline().split() for _ in range(count)]
                data = np.array(rows, dtype=np.float64)
                if name == 'vertex':
                    for i, (pname, ptype) in enumerate(elem_props):
                        result[pname] = data[:, i].astype(np.dtype(ptype))
            else:
                endian = '<' if fmt == 'binary_little_endian' else '>'
                dtype = np.dtype([(pname, endian + ptype)
                                  for pname, ptype in elem_props])
                raw = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype)
                if name == 'vertex':
                    for pname, _ in elem_props:
                        result[pname] = np.ascontiguousarray(raw[pname])
    return result


def write_ply_vertices(props: dict[str, np.ndarray], path: str | Path,
                       ascii_format: bool = False) -> None:
    """Write a dict of equal-length 1-D arrays as a PLY 'vertex' element.

    Property order follows dict insertion order (matches the 3DGS vertex
    layout convention when called from model export)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    names = list(props)
    count = len(props[names[0]])
    arrays = {}
    for name in names:
        arr = np.asarray(props[name]).reshape(count)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        arrays[name] = arr
    header = ['ply',
              'format ascii 1.0' if ascii_format else 'format binary_little_endian 1.0',
              f'element vertex {count}']
    for name in names:
        kind = arrays[name].dtype.str.lstrip('<>=|')
        header.append(f'property {_DTYPE_NAMES[kind]} {name}')
    header.append('end_header')
    with open(path, 'wb') as f:
        f.write(('\n'.join(header) + '\n').encode('ascii'))
        if ascii_format:
            stacked = np.stack([arrays[n].astype(np.float64) for n in names], axis=1)
            np.savetxt(f, stacked, fmt='%.8g')
        else:
            rec = np.rec.fromarrays([arrays[n] for n in names], names=names)
            f.write(rec.tobytes())


def read_ply_pointcloud(path: str | Path):
    from nerficg_torch.data.types import BasicPointCloud
    verts = read_ply_vertices(path)
    positions = np.stack([verts['x'], verts['y'], verts['z']], axis=-1)
    colors = None
    if 'red' in verts:
        colors = np.stack([verts['red'], verts['green'], verts['blue']], axis=-1)
        if colors.dtype == np.uint8:
            colors = colors.astype(np.float32) / 255.0
    normals = None
    if 'nx' in verts:
        normals = np.stack([verts['nx'], verts['ny'], verts['nz']], axis=-1)
    return BasicPointCloud(positions, colors, normals)


def write_ply_pointcloud(pcd, path: str | Path) -> None:
    props = {'x': pcd.positions[:, 0], 'y': pcd.positions[:, 1],
             'z': pcd.positions[:, 2]}
    if pcd.normals is not None:
        props.update(nx=pcd.normals[:, 0], ny=pcd.normals[:, 1],
                     nz=pcd.normals[:, 2])
    if pcd.colors is not None:
        colors = (np.clip(pcd.colors, 0, 1) * 255).astype(np.uint8)
        props.update(red=colors[:, 0], green=colors[:, 1], blue=colors[:, 2])
    write_ply_vertices(props, path)
