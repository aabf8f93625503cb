"""Procedural synthetic scene in the Blender (NeRF) format, ported from
nerficg_tpu/data/synthetic.py ``make_textured_scene`` (:89): an opaque
sphere of radius 0.8 with a multi-octave procedural 3D texture, rendered
analytically (ray-sphere intersection + Lambertian shading, 2x
supersampled) from a ring of cameras at distance 4. Numpy and PIL only,
so both packages write the same files from the same seed."""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
from PIL import Image

__all__ = ['make_textured_scene']


def make_textured_scene(root, image_size=128, n_train=30, n_test=4,
                        octaves=(3.0, 8.0, 14.0), seed=0):
    """Write ``transforms_{train,test}.json`` and RGBA PNGs under ``root``.

    Every visible surface point sits at ray depth in [3.2, 4.8], beyond the
    Blender loader's near plane of 2.0."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    # Random per-octave RGB phase/direction so channels decorrelate.
    dirs_oct = rng.normal(size=(len(octaves), 3, 3))
    dirs_oct /= np.linalg.norm(dirs_oct, axis=-1, keepdims=True)
    phases = rng.uniform(0, 2 * np.pi, size=(len(octaves), 3))
    light = np.array([0.5, 0.7, 0.5])
    light /= np.linalg.norm(light)
    radius = 0.8

    def texture(p):
        """Multi-octave sine texture in [0,1]^3 -> RGB, view-independent."""
        c = np.full(p.shape[:-1] + (3,), 0.5)
        amp = 0.5
        for o, f in enumerate(octaves):
            amp *= 0.55
            for ch in range(3):
                c[..., ch] += amp * np.sin(
                    2 * np.pi * f * (p @ dirs_oct[o, ch]) + phases[o, ch])
        return np.clip(c, 0.0, 1.0)

    def render(c2w, size, ss=2):
        hs = size * ss
        focal = 0.5 * hs / math.tan(0.5 * math.radians(45.0))
        ys, xs = np.mgrid[0:hs, 0:hs].astype(np.float64) + 0.5
        d = np.stack([(xs - hs / 2) / focal, (ys - hs / 2) / focal,
                      np.ones_like(xs)], -1)
        d = d @ c2w[:3, :3].T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = c2w[:3, 3]
        # ray-sphere: |o + t d|^2 = r^2
        b = d @ o
        disc = b * b - (o @ o - radius * radius)
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        p = o[None, None, :] + d * t[..., None]
        n = p / radius
        shade = 0.35 + 0.65 * np.maximum(n @ light, 0.0)
        rgb = texture(p) * shade[..., None]
        rgb = np.where(hit[..., None], rgb, 0.0)
        acc = hit.astype(np.float64)
        # box-downsample the supersampled buffers
        rgb = rgb.reshape(size, ss, size, ss, 3).mean(axis=(1, 3))
        acc = acc.reshape(size, ss, size, ss).mean(axis=(1, 3))
        return np.clip(rgb, 0, 1), acc

    def pose_on_ring(angle, elev, radius_cam=4.0):
        eye = radius_cam * np.array([
            math.cos(elev) * math.sin(angle), math.sin(elev),
            math.cos(elev) * math.cos(angle)])
        forward = -eye / np.linalg.norm(eye)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, forward)
        right /= np.linalg.norm(right)
        down = np.cross(forward, right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = \
            right, down, forward, eye
        return c2w

    for split, count in (('train', n_train), ('test', n_test)):
        frames = []
        (root / split).mkdir(parents=True, exist_ok=True)
        for i in range(count):
            angle = 2 * math.pi * (i + (0.5 if split == 'test' else 0)) \
                / max(count, 1)
            # two elevation bands so the poles are observed
            elev = math.radians(-25.0 if i % 2 else 20.0)
            c2w_colmap = pose_on_ring(angle, elev)
            rgb, acc = render(c2w_colmap, image_size)
            rgba = np.concatenate([rgb, acc[..., None]], -1)
            img = Image.fromarray((rgba * 255).astype(np.uint8))
            rel = f'{split}/r_{i}'
            img.save(root / f'{rel}.png')
            c2w_gl = c2w_colmap.copy()
            c2w_gl[:3, 1] *= -1
            c2w_gl[:3, 2] *= -1
            frames.append({'file_path': f'./{rel}',
                           'transform_matrix': c2w_gl.tolist()})
        meta = {'camera_angle_x': math.radians(45.0), 'frames': frames}
        with open(root / f'transforms_{split}.json', 'w') as f:
            json.dump(meta, f)
    return root
