"""Image IO, ported from nerficg_tpu/data/io.py (the part the serving path
uses; reference: src/Datasets/utils.py:134-225). Decoding and encoding go
through PIL."""

from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image

__all__ = ['load_image', 'save_image', 'resize_image']


def load_image(path: str | Path, scale_factor: float | None = None) -> np.ndarray:
    """Decode an image file -> float32 HWC array in [0, 1]; an alpha channel
    is kept; 16-bit PNGs are scaled by 65535, 8-bit by 255."""
    with Image.open(path) as img:
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
    """Resize a float32 HWC image (1, 3 or 4 channels) with Lanczos filtering."""
    if scale_factor == 1.0:
        return image
    h, w = image.shape[:2]
    new_size = (max(int(round(w * scale_factor)), 1),
                max(int(round(h * scale_factor)), 1))
    channels = image.shape[2]
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
