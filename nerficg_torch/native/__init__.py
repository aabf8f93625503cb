"""Native (C++) image decoding, built at first use with the system g++.

Port of nerficg_tpu/native/__init__.py. ``image_io.cpp`` (the port's own
copy of the JAX package's source) decodes PNG and JPEG with libpng and
libjpeg on an ``std::thread`` pool outside the GIL, behind a plain C ABI
bound with ctypes. ``data/io.py`` decodes through it, as the JAX package's
does: PIL reads a 16-bit colour PNG as 8 bits and hands back a palette
image's indices, so only this decoder gives the JAX package's arrays.

The library is compiled once into ``build/`` at the repository root (as
``ops/_kernels.py`` builds the CUDA kernels), keyed by a hash of the source
and the command:

  g++ -O3 -shared -fPIC -std=c++17 image_io.cpp -lpng -ljpeg -lz -lpthread

Where there is no g++ or the libpng/libjpeg headers, the build fails and
the decoder is unavailable: callers decode with PIL, which is what the JAX
package does on such a machine. ``NERFICG_DISABLE_NATIVE`` set to anything
non-empty makes it unavailable too. The decoder in use is logged once. A
library that builds and then fails to load, or fails to decode a file,
raises (a file that does not open: FileNotFoundError).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from nerficg_torch.core.errors import DatasetError
from nerficg_torch.core.logging import Logger

__all__ = ['native_io_available', 'decode_image', 'decode_batch',
           'build_library']

_SRC = Path(__file__).with_name('image_io.cpp')
_BUILD_DIR = Path(__file__).resolve().parents[2] / 'build'
_FLAGS = ['-O3', '-shared', '-fPIC', '-std=c++17']
_LIBS = ['-lpng', '-ljpeg', '-lz', '-lpthread']
# The C entry points' return codes (image_io.cpp's header).
_CODES = {-1: 'the file does not open', -2: 'not a PNG file',
          -3: 'libpng ran out of memory', -4: 'damaged file',
          -5: 'out of memory', -10: 'neither .png nor .jpg/.jpeg'}

_FloatP = ctypes.POINTER(ctypes.c_float)
_IntP = ctypes.POINTER(ctypes.c_int)
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_checked = False


def build_library() -> tuple[Optional[Path], str]:
    """Compile image_io.cpp into build/ unless an identical build exists.
    Returns (library path, what happened), the path None where the build
    failed (no g++, or no libpng/libjpeg headers or libraries)."""
    digest = hashlib.sha256(' '.join(_FLAGS + _LIBS).encode())
    digest.update(_SRC.read_bytes())
    out = _BUILD_DIR / f'image_io_{digest.hexdigest()[:16]}.so'
    if out.is_file():
        return out, 'reused'
    compiler = shutil.which('g++')
    if compiler is None:
        return None, 'no g++ on PATH'
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    try:
        result = subprocess.run([compiler, *_FLAGS, str(_SRC), '-o', str(tmp),
                                 *_LIBS], capture_output=True, text=True,
                                timeout=120)
    except subprocess.TimeoutExpired:
        tmp.unlink(missing_ok=True)
        return None, 'g++ timed out after 120 s'
    if result.returncode != 0:
        tmp.unlink(missing_ok=True)
        last = (result.stderr.strip().splitlines() or ['no output'])[-1]
        return None, f'g++ failed ({result.returncode}): {last}'
    os.replace(tmp, out)
    return out, 'built'


def _bind(path: Path) -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as exc:
        raise DatasetError(f'the native image decoder {path} was built but '
                           f'does not load: {exc}') from exc
    lib.decode_image.restype = ctypes.c_int
    lib.decode_image.argtypes = [ctypes.c_char_p, ctypes.POINTER(_FloatP),
                                 _IntP, _IntP, _IntP]
    lib.decode_batch.restype = ctypes.c_int
    lib.decode_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                 ctypes.c_int, ctypes.POINTER(_FloatP),
                                 _IntP, _IntP, _IntP, _IntP]
    lib.free_buffer.restype = None
    lib.free_buffer.argtypes = [_FloatP]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The bound library, or None where the decoder is unavailable; builds
    it on the first call of the process and logs which decoder is in
    use."""
    global _lib, _checked
    with _lock:
        if _checked:
            return _lib
        if os.environ.get('NERFICG_DISABLE_NATIVE'):
            Logger.info('image decoder: PIL (NERFICG_DISABLE_NATIVE is set)')
        else:
            path, what = build_library()
            if path is None:
                Logger.info(f'image decoder: PIL (the native decoder does '
                            f'not build: {what})')
            else:
                _lib = _bind(path)
                Logger.info(f'image decoder: native, {path.name} ({what})')
        _checked = True
        return _lib


def native_io_available() -> bool:
    return _load() is not None


def _fail(path, code: int) -> Exception:
    """The error of a failed decode: FileNotFoundError for a file that does
    not open (what PIL raises in the JAX package's path), else a
    DatasetError."""
    message = f'native decode of {path} failed ({code}: ' \
              f'{_CODES.get(code, "unknown code")})'
    return FileNotFoundError(message) if code == -1 else DatasetError(message)


def _take(lib: ctypes.CDLL, ptr, h: int, w: int, c: int) -> np.ndarray:
    """Copy a malloc'd float32 HWC buffer out and free it."""
    arr = np.ctypeslib.as_array(ptr, shape=(h * w * c,)).astype(np.float32,
                                                                copy=True)
    lib.free_buffer(ptr)
    return arr.reshape(h, w, c)


def decode_image(path: str | Path) -> Optional[np.ndarray]:
    """Decode a .png/.jpg/.jpeg file into float32 HWC in [0, 1]; None
    where the decoder is unavailable. Raises where it fails."""
    lib = _load()
    if lib is None:
        return None
    ptr = _FloatP()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    code = lib.decode_image(str(path).encode(), ctypes.byref(ptr),
                            ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
    if code != 0:
        raise _fail(path, code)
    return _take(lib, ptr, h.value, w.value, c.value)


def decode_batch(paths: list, n_threads: int = 8) -> Optional[list]:
    """Decode many files on the library's thread pool, in order; None
    where the decoder is unavailable or ``paths`` is empty. Raises where a
    file fails (after freeing every decoded buffer)."""
    lib = _load()
    if lib is None or not paths:
        return None
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    ptrs = (_FloatP * n)()
    hs, ws, cs, codes = [(ctypes.c_int * n)() for _ in range(4)]
    if lib.decode_batch(c_paths, n, n_threads, ptrs, hs, ws, cs, codes) != 0:
        for i in range(n):
            if codes[i] == 0 and ptrs[i]:
                lib.free_buffer(ptrs[i])
        bad = next(i for i in range(n) if codes[i] != 0)
        raise _fail(paths[bad], codes[bad])
    return [_take(lib, ptrs[i], hs[i], ws[i], cs[i]) for i in range(n)]
