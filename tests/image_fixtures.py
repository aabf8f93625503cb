"""PNG and JPEG fixtures of known arrays, for the image decoder's checks
(tests/test_torch_image_io.py, and chip_smoke.py phase 20 on the card).

Imports numpy and PIL only: neither torch nor jax.
"""

import struct
import zlib
from pathlib import Path

import numpy as np
from PIL import Image

__all__ = ['write_png', 'write_fixtures']

_PALETTE = np.random.default_rng(7).integers(0, 256, (16, 3), np.uint8)
_TRNS = np.arange(0, 256, 32, dtype=np.uint8)[:6]


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + kind + data +
            struct.pack('>I', zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, rows: np.ndarray, color_type: int, bit_depth: int,
              palette=None, trns=None) -> None:
    """A PNG of ``rows`` (H, W, C) samples as the PNG specification lays
    them out (test code): big-endian 16-bit samples, sub-byte samples
    packed from the high bit, filter 0 on every row."""
    h, w = rows.shape[:2]
    if bit_depth == 16:
        data = rows.astype('>u2').reshape(h, -1).view(np.uint8)
    elif bit_depth == 8:
        data = rows.astype(np.uint8).reshape(h, -1)
    else:
        per_byte = 8 // bit_depth
        flat = rows.reshape(h, -1).astype(np.uint8)
        flat = np.pad(flat, ((0, 0), (0, -w % per_byte)))
        flat = flat.reshape(h, -1, per_byte)
        shifts = (8 - bit_depth * (np.arange(per_byte) + 1)).astype(np.uint8)
        data = np.bitwise_or.reduce(flat << shifts, axis=-1).astype(np.uint8)
    raw = b''.join(b'\x00' + row.tobytes() for row in data)
    out = b'\x89PNG\r\n\x1a\n' + _chunk(
        b'IHDR', struct.pack('>IIBBBBB', w, h, bit_depth, color_type, 0, 0, 0))
    if palette is not None:
        out += _chunk(b'PLTE', palette.tobytes())
    if trns is not None:
        out += _chunk(b'tRNS', trns.tobytes())
    out += _chunk(b'IDAT', zlib.compress(raw)) + _chunk(b'IEND', b'')
    Path(path).write_bytes(out)


def write_fixtures(root) -> dict:
    """Every fixture -> (path, the array the native decoder must return;
    None for a JPEG, held to PIL's decode)."""
    rng = np.random.default_rng(0)
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    s8, s16 = np.float32(1.0 / 255.0), np.float32(1.0 / 65535.0)
    fixtures = {}
    for name, channels, color_type in (('rgb', 3, 2), ('rgba', 4, 6),
                                       ('gray', 1, 0), ('gray_alpha', 2, 4)):
        for depth, scale in ((8, s8), (16, s16)):
            a = rng.integers(0, 2 ** depth, (13, 17, channels),
                             np.uint16 if depth == 16 else np.uint8)
            path = root / f'{name}{depth}.png'
            write_png(path, a, color_type, depth)
            fixtures[f'{name}{depth}'] = (path, a.astype(np.float32) * scale)
    gray2 = rng.integers(0, 4, (9, 11, 1), np.uint8)
    write_png(root / 'gray2.png', gray2, 0, 2)
    fixtures['gray2'] = (root / 'gray2.png',
                         (gray2 * 85).astype(np.float32) * s8)
    idx = rng.integers(0, len(_PALETTE), (12, 10, 1), np.uint8)
    write_png(root / 'palette.png', idx, 3, 8, palette=_PALETTE)
    fixtures['palette'] = (root / 'palette.png',
                           _PALETTE[idx[..., 0]].astype(np.float32) * s8)
    alpha = np.full(len(_PALETTE), 255, np.uint8)
    alpha[:len(_TRNS)] = _TRNS
    write_png(root / 'palette_trns.png', idx, 3, 8, palette=_PALETTE,
              trns=_TRNS)
    rgba = np.concatenate([_PALETTE, alpha[:, None]], axis=1)[idx[..., 0]]
    fixtures['palette_trns'] = (root / 'palette_trns.png',
                                rgba.astype(np.float32) * s8)
    xs = np.linspace(0, 1, 24, dtype=np.float32)
    smooth = (np.stack([np.outer(xs, xs), np.outer(1 - xs, xs),
                        np.outer(xs, 1 - xs)], -1) * 255).astype(np.uint8)
    Image.fromarray(smooth).save(root / 'rgb.jpg', quality=90)
    Image.fromarray(smooth[..., 0]).save(root / 'gray.jpeg', quality=90)
    fixtures['rgb_jpg'] = (root / 'rgb.jpg', None)
    fixtures['gray_jpeg'] = (root / 'gray.jpeg', None)
    return fixtures
