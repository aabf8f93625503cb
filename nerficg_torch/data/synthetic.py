"""Procedural synthetic scenes in the Blender (NeRF) and D-NeRF formats,
ported from nerficg_tpu/data/synthetic.py:
``make_synthetic_scene`` (:20) and ``make_dynamic_scene`` (:202), an
analytically composited gaussian density blob (static, or moving along x
with time) seen from a ring of cameras at distance 4; and
``make_textured_scene`` (:89) and ``make_dynamic_textured_scene`` (:269), an
opaque sphere of radius 0.8 with a multi-octave procedural 3D texture,
rendered analytically (ray-sphere intersection + Lambertian shading, 2x
supersampled) from two elevation bands of that ring (static, or translating
with time). Numpy and PIL only, so both packages write the same files from
the same arguments."""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
from PIL import Image

__all__ = ['make_synthetic_scene', 'make_dynamic_scene',
           'make_textured_scene', 'make_dynamic_textured_scene']

_RADIUS = 0.8


def _texture_fn(rng, octaves):
    """Multi-octave sine texture in [0,1]^3 -> RGB, view-independent, with a
    random per-octave RGB phase and direction so channels decorrelate."""
    dirs_oct = rng.normal(size=(len(octaves), 3, 3))
    dirs_oct /= np.linalg.norm(dirs_oct, axis=-1, keepdims=True)
    phases = rng.uniform(0, 2 * np.pi, size=(len(octaves), 3))

    def texture(p):
        c = np.full(p.shape[:-1] + (3,), 0.5)
        amp = 0.5
        for o, f in enumerate(octaves):
            amp *= 0.55
            for ch in range(3):
                c[..., ch] += amp * np.sin(
                    2 * np.pi * f * (p @ dirs_oct[o, ch]) + phases[o, ch])
        return np.clip(c, 0.0, 1.0)

    return texture


def _focal_rays(c2w, size):
    """World directions of a ``size`` x ``size`` 45-degree camera's pixel
    centres."""
    focal = 0.5 * size / math.tan(0.5 * math.radians(45.0))
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float64) + 0.5
    d = np.stack([(xs - size / 2) / focal, (ys - size / 2) / focal,
                  np.ones_like(xs)], -1)
    d = d @ c2w[:3, :3].T
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _shade_sphere(texture, o, d, center):
    """(rgb, hit) of rays from ``o`` along unit directions ``d`` (H, W, 3)
    against the textured sphere around ``center`` (the texture and shading
    move with it): the first intersection, Lambertian-shaded, black where
    a ray misses."""
    light = np.array([0.5, 0.7, 0.5])
    light /= np.linalg.norm(light)
    # ray-sphere: |o - center + t d|^2 = r^2
    oc = o - center
    b = d @ oc
    disc = b * b - (oc @ oc - _RADIUS * _RADIUS)
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    p = o[None, None, :] + d * t[..., None] - center      # body frame
    n = p / _RADIUS
    shade = 0.35 + 0.65 * np.maximum(n @ light, 0.0)
    rgb = texture(p) * shade[..., None]
    return np.where(hit[..., None], rgb, 0.0), hit


def _render_sphere(texture, c2w, size, center, ss=2):
    """(rgb, acc) of the textured sphere around ``center`` seen by a
    45-degree camera, box-downsampled from ``ss`` x supersampling."""
    rgb, hit = _shade_sphere(texture, c2w[:3, 3], _focal_rays(c2w, size * ss),
                             center)
    acc = hit.astype(np.float64)
    rgb = rgb.reshape(size, ss, size, ss, 3).mean(axis=(1, 3))
    acc = acc.reshape(size, ss, size, ss).mean(axis=(1, 3))
    return np.clip(rgb, 0, 1), acc


def _pose_on_ring(angle, elev, radius_cam=4.0):
    eye = radius_cam * np.array([
        math.cos(elev) * math.sin(angle), math.sin(elev),
        math.cos(elev) * math.cos(angle)])
    forward = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, forward)
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, forward, eye
    return c2w


def _render_blob(c2w, size, center):
    """(rgb, acc) of a gaussian density blob (peak 8, sigma 0.4) around
    ``center``, alpha-composited over 64 steps from t=2 to t=6, its colour
    0.5 + 0.5 tanh of the position relative to the centre."""
    dirs = _focal_rays(c2w, size)
    origin = c2w[:3, 3]
    ts = np.linspace(2.0, 6.0, 64)
    dt = ts[1] - ts[0]
    pts = origin[None, None, None, :] + \
        dirs[:, :, None, :] * ts[None, None, :, None]
    r2 = np.sum((pts - center) ** 2, axis=-1)
    sigma = 8.0 * np.exp(-r2 / (2 * 0.4 ** 2))
    alpha = 1.0 - np.exp(-sigma * dt)
    trans = np.cumprod(1.0 - alpha + 1e-10, axis=-1)
    trans = np.concatenate([np.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    w = trans * alpha
    color = 0.5 + 0.5 * np.tanh(pts[..., :3] - center)
    rgb = np.einsum('hws,hwsc->hwc', w, color)
    return np.clip(rgb, 0, 1), np.clip(w.sum(-1), 0, 1)


def _write_scene(root: Path, image_size, n_train, n_test, render,
                 timed=False, elevations=(20.0, -25.0)):
    """Both splits' RGBA PNGs and transforms. Cameras on a ring at distance
    4, frame i at ``elevations[i % 2]`` degrees, the test ring offset by
    half a step; ``render(c2w, size, t)`` gives (rgb, acc), frame i of a
    split at time t = i / (count - 1), written as the frame's ``time`` when
    ``timed``."""
    for split, count in (('train', n_train), ('test', n_test)):
        frames = []
        (root / split).mkdir(parents=True, exist_ok=True)
        for i in range(count):
            t = i / max(count - 1, 1)
            angle = 2 * math.pi * (i + (0.5 if split == 'test' else 0)) \
                / max(count, 1)
            c2w_colmap = _pose_on_ring(angle,
                                       math.radians(elevations[i % 2]))
            rgb, acc = render(c2w_colmap, image_size, t)
            rgba = np.concatenate([rgb, acc[..., None]], -1)
            img = Image.fromarray((rgba * 255).astype(np.uint8))
            rel = f'{split}/r_{i}'
            img.save(root / f'{rel}.png')
            c2w_gl = c2w_colmap.copy()
            c2w_gl[:3, 1] *= -1
            c2w_gl[:3, 2] *= -1
            frame = {'file_path': f'./{rel}'}
            if timed:
                frame['time'] = t
            frame['transform_matrix'] = c2w_gl.tolist()
            frames.append(frame)
        meta = {'camera_angle_x': math.radians(45.0), 'frames': frames}
        with open(root / f'transforms_{split}.json', 'w') as f:
            json.dump(meta, f)
    return root


def make_synthetic_scene(root, image_size=24, n_train=8, n_test=2):
    """The static gaussian blob at the origin (``_render_blob``), cameras on
    the equator, in the Blender format under ``root``."""
    return _write_scene(
        Path(root), image_size, n_train, n_test,
        lambda c2w, size, t: _render_blob(c2w, size, np.zeros(3)),
        elevations=(0.0, 0.0))


def make_dynamic_scene(root, image_size=24, n_train=10, n_test=3):
    """The blob moving along x, its centre at [0.6 (t - 0.5), 0, 0], cameras
    on the equator, in the D-NeRF format (a ``time`` per frame)."""
    return _write_scene(
        Path(root), image_size, n_train, n_test,
        lambda c2w, size, t: _render_blob(
            c2w, size, np.array([0.6 * (t - 0.5), 0.0, 0.0])),
        timed=True, elevations=(0.0, 0.0))


def make_textured_scene(root, image_size=128, n_train=30, n_test=4,
                        octaves=(3.0, 8.0, 14.0), seed=0):
    """Write ``transforms_{train,test}.json`` and RGBA PNGs under ``root``.

    Every visible surface point sits at ray depth in [3.2, 4.8], beyond the
    Blender loader's near plane of 2.0."""
    texture = _texture_fn(np.random.default_rng(seed), octaves)
    return _write_scene(
        Path(root), image_size, n_train, n_test,
        lambda c2w, size, t: _render_sphere(texture, c2w, size, np.zeros(3)))


def make_dynamic_textured_scene(root, image_size=64, n_train=40, n_test=4,
                                octaves=(3.0, 8.0), amplitude=0.35, seed=0):
    """The textured sphere rigidly translating with time, its centre at
    [amplitude * sin(2 pi t), 0, 0] (texture and shading move with it): the
    canonical frame plus offset that D-NeRF assumes. In the D-NeRF format
    (a ``time`` per frame; ``data/loaders/dnerf.py``). The surface stays at
    depth > 2 from every camera (4.0 - 0.8 - |amplitude| >= 2.85)."""
    texture = _texture_fn(np.random.default_rng(seed), octaves)
    return _write_scene(
        Path(root), image_size, n_train, n_test,
        lambda c2w, size, t: _render_sphere(
            texture, c2w, size,
            np.array([amplitude * math.sin(2 * math.pi * t), 0.0, 0.0])),
        timed=True)
