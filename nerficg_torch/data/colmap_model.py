"""COLMAP sparse-reconstruction reader (binary and text formats), a port of
nerficg_tpu/data/colmap_model.py.

It stands in for the reference's pycolmap dependency
(src/Datasets/Colmap.py:20-174 reads cameras/images/points3D through
pycolmap.Reconstruction) and reads the documented COLMAP model format
directly, byte for byte as the JAX package does:
  cameras.bin / cameras.txt   — intrinsics per camera
  images.bin  / images.txt    — per-image pose (world-to-cam quaternion+t)
  points3D.bin / points3D.txt — sparse points with colors
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from nerficg_torch.cameras.pose import quaternion_to_rotation_matrix

__all__ = ['ColmapCamera', 'ColmapImage', 'read_colmap_model',
           'CAMERA_MODEL_NAMES']

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ('SIMPLE_PINHOLE', 3), 1: ('PINHOLE', 4), 2: ('SIMPLE_RADIAL', 4),
    3: ('RADIAL', 5), 4: ('OPENCV', 8), 5: ('OPENCV_FISHEYE', 8),
    6: ('FULL_OPENCV', 12), 7: ('FOV', 5), 8: ('SIMPLE_RADIAL_FISHEYE', 4),
    9: ('RADIAL_FISHEYE', 5), 10: ('THIN_PRISM_FISHEYE', 12),
}
CAMERA_MODEL_NAMES = {name: (mid, n) for mid, (name, n) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    def intrinsics(self) -> dict:
        """-> dict(focal_x, focal_y, center_x, center_y, distortion dict)."""
        p = self.params
        dist: dict = {}
        if self.model == 'SIMPLE_PINHOLE':
            fx = fy = p[0]; cx, cy = p[1], p[2]
        elif self.model == 'PINHOLE':
            fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        elif self.model == 'SIMPLE_RADIAL':
            fx = fy = p[0]; cx, cy = p[1], p[2]
            dist = {'k1': p[3]}
        elif self.model == 'RADIAL':
            fx = fy = p[0]; cx, cy = p[1], p[2]
            dist = {'k1': p[3], 'k2': p[4]}
        elif self.model == 'OPENCV':
            fx, fy, cx, cy = p[0], p[1], p[2], p[3]
            dist = {'k1': p[4], 'k2': p[5], 'p1': p[6], 'p2': p[7]}
        elif self.model == 'FULL_OPENCV':
            fx, fy, cx, cy = p[0], p[1], p[2], p[3]
            dist = {'k1': p[4], 'k2': p[5], 'p1': p[6], 'p2': p[7],
                    'k3': p[8], 'k4': p[9], 'k5': p[10], 'k6': p[11]}
        else:
            raise ValueError(f'unsupported COLMAP camera model {self.model}')
        return {'focal_x': float(fx), 'focal_y': float(fy),
                'center_x': float(cx), 'center_y': float(cy),
                'distortion': {k: float(v) for k, v in dist.items()}}


@dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray        # wxyz world-to-cam rotation
    tvec: np.ndarray        # world-to-cam translation
    camera_id: int
    name: str

    def c2w(self) -> np.ndarray:
        rot = quaternion_to_rotation_matrix(self.qvec)
        c2w = np.eye(4)
        c2w[:3, :3] = rot.T
        c2w[:3, 3] = -rot.T @ self.tvec
        return c2w


def _read_next_bytes(f, num_bytes, fmt):
    return struct.unpack('<' + fmt, f.read(num_bytes))


def _read_cameras_bin(path: Path) -> dict[int, ColmapCamera]:
    cameras = {}
    with open(path, 'rb') as f:
        (num,) = _read_next_bytes(f, 8, 'Q')
        for _ in range(num):
            cam_id, model_id, width, height = _read_next_bytes(f, 24, 'iiQQ')
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read_next_bytes(f, 8 * num_params,
                                               'd' * num_params))
            cameras[cam_id] = ColmapCamera(cam_id, name, int(width),
                                           int(height), params)
    return cameras


def _read_images_bin(path: Path) -> dict[int, ColmapImage]:
    images = {}
    with open(path, 'rb') as f:
        (num,) = _read_next_bytes(f, 8, 'Q')
        for _ in range(num):
            vals = _read_next_bytes(f, 64, 'idddddddi')
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b''
            while True:
                c = f.read(1)
                if c == b'\x00':
                    break
                name += c
            (num_points,) = _read_next_bytes(f, 8, 'Q')
            f.seek(24 * num_points, 1)  # skip 2D points
            images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id,
                                           name.decode('utf-8'))
    return images


def _read_points_bin(path: Path) -> tuple[np.ndarray, np.ndarray]:
    positions, colors = [], []
    with open(path, 'rb') as f:
        (num,) = _read_next_bytes(f, 8, 'Q')
        for _ in range(num):
            vals = _read_next_bytes(f, 43, 'QdddBBBd')
            positions.append(vals[1:4])
            colors.append(vals[4:7])
            (track_len,) = _read_next_bytes(f, 8, 'Q')
            f.seek(8 * track_len, 1)
    return (np.asarray(positions, np.float32),
            np.asarray(colors, np.float32) / 255.0)


def _read_cameras_txt(path: Path) -> dict[int, ColmapCamera]:
    cameras = {}
    for line in open(path):
        line = line.strip()
        if not line or line.startswith('#'):
            continue
        parts = line.split()
        cam_id, model = int(parts[0]), parts[1]
        cameras[cam_id] = ColmapCamera(
            cam_id, model, int(parts[2]), int(parts[3]),
            np.array([float(x) for x in parts[4:]]))
    return cameras


def _read_images_txt(path: Path) -> dict[int, ColmapImage]:
    images = {}
    lines = [ln.strip() for ln in open(path)
             if ln.strip() and not ln.startswith('#')]
    for meta in lines[::2]:
        parts = meta.split()
        images[int(parts[0])] = ColmapImage(
            int(parts[0]), np.array([float(x) for x in parts[1:5]]),
            np.array([float(x) for x in parts[5:8]]), int(parts[8]), parts[9])
    return images


def _read_points_txt(path: Path) -> tuple[np.ndarray, np.ndarray]:
    positions, colors = [], []
    for line in open(path):
        line = line.strip()
        if not line or line.startswith('#'):
            continue
        parts = line.split()
        positions.append([float(x) for x in parts[1:4]])
        colors.append([float(x) for x in parts[4:7]])
    return (np.asarray(positions, np.float32),
            np.asarray(colors, np.float32) / 255.0)


def read_colmap_model(model_dir: str | Path):
    """-> (cameras {id: ColmapCamera}, images {id: ColmapImage},
           (positions, colors) or (None, None))."""
    model_dir = Path(model_dir)
    if (model_dir / 'cameras.bin').is_file():
        cameras = _read_cameras_bin(model_dir / 'cameras.bin')
        images = _read_images_bin(model_dir / 'images.bin')
        points = (_read_points_bin(model_dir / 'points3D.bin')
                  if (model_dir / 'points3D.bin').is_file() else (None, None))
    elif (model_dir / 'cameras.txt').is_file():
        cameras = _read_cameras_txt(model_dir / 'cameras.txt')
        images = _read_images_txt(model_dir / 'images.txt')
        points = (_read_points_txt(model_dir / 'points3D.txt')
                  if (model_dir / 'points3D.txt').is_file() else (None, None))
    else:
        raise FileNotFoundError(f'no COLMAP model found in {model_dir}')
    return cameras, images, points
