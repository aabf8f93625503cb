"""Image, optical-flow and color-space IO, ported from nerficg_tpu/data/io.py
(reference: src/Datasets/utils.py: load_images :134-149, save_image
:207-225, Middlebury .flo IO :82-99,228-278, sRGB conversions :38-47, flow
visualization :281-297). PNG and JPEG decode through the native decoder
(``nerficg_torch/native``: libpng/libjpeg outside the GIL, the JAX
package's arrays bit for bit), anything else, or everything where that
decoder is unavailable, through PIL; encoding goes through PIL. Parallel
decoding uses the native decoder's thread pool, or a thread pool of PIL
decodes (PIL releases the GIL while it decodes)."""

from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
from PIL import Image

from nerficg_torch.native import decode_batch, decode_image

__all__ = ['load_image', 'save_image', 'resize_image', 'load_images_parallel',
           'read_flow', 'write_flow', 'flow_to_color',
           'srgb_to_linear', 'linear_to_srgb']

_FLO_MAGIC = 202021.25
_NATIVE_SUFFIXES = {'png', 'jpg', 'jpeg'}


def load_image(path: str | Path, scale_factor: float | None = None) -> np.ndarray:
    """Decode an image file -> float32 HWC array in [0, 1]; an alpha channel
    is kept; 16-bit PNGs are scaled by 65535, 8-bit by 255.

    In the JAX package's order: a .png/.jpg/.jpeg through the native
    decoder where it is available, resized by ``resize_image`` for a scale
    factor; anything else through PIL."""
    if str(path).lower().rsplit('.', 1)[-1] in _NATIVE_SUFFIXES:
        arr = decode_image(path)
        if arr is not None:
            if scale_factor is not None and scale_factor != 1.0:
                arr = resize_image(arr, scale_factor)
            return arr
    return _load_pil(path, scale_factor)


def _load_pil(path: str | Path, scale_factor: float | None = None
              ) -> np.ndarray:
    """``load_image`` through PIL (resized by PIL for a scale factor): a
    16-bit colour PNG comes back as 8 bits. A palette image comes back as
    its colours, RGBA where it has transparency, as the native decoder
    expands it (the JAX package's PIL path returns the indices / 255)."""
    with Image.open(path) as img:
        if img.mode == 'P':
            img = img.convert('RGBA' if 'transparency' in img.info
                              else 'RGB')
        if scale_factor is not None and scale_factor != 1.0:
            new_size = (max(int(round(img.width * scale_factor)), 1),
                        max(int(round(img.height * scale_factor)), 1))
            img = img.resize(new_size, Image.LANCZOS)
        arr = np.asarray(img)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    elif arr.dtype in (np.uint16, np.int32, np.uint32):
        arr = arr.astype(np.float32) / 65535.0
    else:
        arr = arr.astype(np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def resize_image(image: np.ndarray, scale_factor: float) -> np.ndarray:
    """Resize a float32 HWC image: 1, 3 or 4 channels through 8 bits with
    Lanczos filtering, any other count (2-channel flow) channel by channel
    in float with bilinear filtering."""
    if scale_factor == 1.0:
        return image
    h, w = image.shape[:2]
    new_size = (max(int(round(w * scale_factor)), 1),
                max(int(round(h * scale_factor)), 1))
    channels = image.shape[2]
    if channels not in (1, 3, 4):
        return np.stack([np.asarray(Image.fromarray(image[..., c]).resize(
            new_size, Image.BILINEAR)) for c in range(channels)],
            axis=-1).astype(np.float32)
    img = Image.fromarray(
        (np.clip(image.squeeze(-1) if channels == 1 else image, 0, 1)
         * 255).astype(np.uint8))
    resized = np.asarray(img.resize(new_size, Image.LANCZOS),
                         dtype=np.float32) / 255.0
    return resized[..., None] if resized.ndim == 2 else resized


def save_image(image: np.ndarray, path: str | Path) -> None:
    """Save a float32 HWC image in [0, 1] as an 8-bit png/jpg
    (reference: Datasets/utils.py:207-225)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arr = np.asarray(image)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    Image.fromarray(arr).save(path)


def load_images_parallel(paths: Sequence[str | Path],
                         scale_factor: float | None = None,
                         load_fn: Callable | None = None,
                         max_workers: int = 8) -> list[np.ndarray]:
    """Decode ``paths`` in order (reference: load_images,
    Datasets/utils.py:134-149): at scale 1 with the default ``load_fn``, PNG
    and JPEG files on the native decoder's thread pool where it is
    available, else ``load_fn`` on a thread pool."""
    fn = load_fn if load_fn is not None else load_image
    if load_fn is None and (scale_factor is None or scale_factor == 1.0) \
            and {str(p).lower().rsplit('.', 1)[-1] for p in paths} \
            <= _NATIVE_SUFFIXES:
        out = decode_batch(list(paths), n_threads=max_workers)
        if out is not None:
            return out
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(lambda p: fn(p, scale_factor), paths))


def read_flow(path: str | Path) -> np.ndarray:
    """Middlebury .flo -> (H, W, 2) float32 (reference: utils.py:228-252)."""
    with open(path, 'rb') as f:
        magic = struct.unpack('f', f.read(4))[0]
        if abs(magic - _FLO_MAGIC) > 1e-3:
            raise ValueError(f'{path}: bad .flo magic {magic}')
        width = struct.unpack('i', f.read(4))[0]
        height = struct.unpack('i', f.read(4))[0]
        data = np.frombuffer(f.read(width * height * 2 * 4), dtype=np.float32)
    return data.reshape(height, width, 2).copy()


def write_flow(flow: np.ndarray, path: str | Path) -> None:
    """(H, W, 2) -> Middlebury .flo in float32 (reference: utils.py:254-278)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    h, w = flow.shape[:2]
    with open(path, 'wb') as f:
        f.write(struct.pack('f', _FLO_MAGIC))
        f.write(struct.pack('i', w))
        f.write(struct.pack('i', h))
        f.write(flow.astype(np.float32).tobytes())


def flow_to_color(flow: np.ndarray, max_radius: float | None = None) -> np.ndarray:
    """Optical flow -> color-wheel RGB: hue from the direction, saturation
    from the magnitude over ``max_radius`` (default: the largest)
    (reference: utils.py:281-297)."""
    u, v = flow[..., 0], flow[..., 1]
    radius = np.sqrt(u * u + v * v)
    if max_radius is None:
        max_radius = max(radius.max(), 1e-6)
    radius = np.clip(radius / max_radius, 0.0, 1.0)
    hue = (np.arctan2(-v, -u) / np.pi + 1.0) / 2.0          # [0, 1]
    h6 = hue * 6.0
    sector = (np.floor(h6).astype(np.int32) % 6)[..., None]
    f = h6 - np.floor(h6)
    s, value = radius, np.ones_like(radius)
    p, q, t = value * (1 - s), value * (1 - f * s), value * (1 - (1 - f) * s)
    rgb = np.select(
        [sector == k for k in range(6)],
        [np.stack(c, -1) for c in ((value, t, p), (q, value, p),
                                   (p, value, t), (p, q, value),
                                   (t, p, value), (value, p, q))])
    return rgb.astype(np.float32)


def srgb_to_linear(srgb: np.ndarray) -> np.ndarray:
    """(reference: Datasets/utils.py:38-42)"""
    return np.where(srgb <= 0.04045, srgb / 12.92,
                    ((srgb + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(linear: np.ndarray) -> np.ndarray:
    """(reference: Datasets/utils.py:44-47)"""
    return np.where(linear <= 0.0031308, linear * 12.92,
                    1.055 * np.clip(linear, 1e-12, None) ** (1.0 / 2.4) - 0.055)
