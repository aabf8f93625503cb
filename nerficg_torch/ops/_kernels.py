"""Build and bind the port's CUDA kernel library.

All kernels under ``nerficg_torch/csrc/*.cu`` (with the shared device helpers
of ``csrc/hash_common.cuh``) compile into ONE shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers: a build
takes seconds instead of the minutes ``torch.utils.cpp_extension`` needs).
Each source compiles in its own ``nvcc`` process, all started together; one
more ``nvcc`` links the objects.
The library is built at first use into ``build/`` at the repository root,
keyed by a hash of the sources and flags, so a fresh checkout on a machine
with ``nvcc`` builds it by itself and later calls reuse it.

Flags: ``sm_90a`` (Hopper), ``-O3``, C++17 and NO ``--use_fast_math``: the
hash encode's window wrap and brick math, and the 3DGS compositor's
alpha > 1/255 test, must round exactly as the plain versions do.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()`` right after the launch; ``check`` raises on a
non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

from nerficg_torch.core.errors import KernelError

__all__ = ['load_library', 'build_library', 'build_variant', 'variant_source',
           'check', 'ptr', 'stream_of', 'require_cuda']

_CSRC = Path(__file__).resolve().parent.parent / 'csrc'
_BUILD_DIR = Path(__file__).resolve().parents[2] / 'build'
_NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-O3', '-std=c++17',
               '-shared', '-Xcompiler', '-fPIC']

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_L = ctypes.c_int64
_FP = ctypes.POINTER(ctypes.c_float)
# C signature of every entry point (all return int = cudaError_t).
_SIGNATURES = {
    'nerficg_hash_window_fwd': [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _P],
    'nerficg_hash_window_fwd_stoch': [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _P, _I, _I, _I, _I, _I, _U, _P],
    'nerficg_hash_window_bwd': [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _P],
    'nerficg_hash_window_bwd_cached': [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    'nerficg_hash_cell_fwd': [_P] * 10 + [_I, _I, _I, _I, _P],
    'nerficg_hash_cell_bwd': [_P] * 10 + [_I] * 4 + [_U, _P],
    'nerficg_hash_xbar_fwd': [_P] * 8 + [_I] * 6 + [_U, _P],
    'nerficg_hash_xbar_bwd_fused': [_P] * 9 + [_I] * 6 + [_U, _P],
    'nerficg_block_probe': [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    'nerficg_block_probe_xyz': [_P] * 7 + [_I] * 6 + [_F, _F, _P],
    'nerficg_seg_gather': [_P, _P, _P, _I, _I, _I, _I, _P],
    'nerficg_seg_scatter_add': [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    'nerficg_gs_composite_fwd': [_P] * 5 + [_I] * 4 + [_P],
    'nerficg_gs_composite_fwd_packed': [_P] * 4 + [_I] * 4 + [_P],
    'nerficg_gs_composite_bwd': [_P] * 6 + [_I] * 4 + [_P],
    'nerficg_gs_tiles_fwd': [_P] * 4 + [_I, _I, _P],
    'nerficg_gs_tiles_bwd': [_P] * 6 + [_I, _I, _P],
    'nerficg_xbar_permute': [_P] * 3 + [_I, _I, _P],
    'nerficg_xbar_gather': [_P] * 3 + [_I, _L, _P],
    'nerficg_gs_frontend_fwd': [_P] * 8 + [_FP] + [_P] * 7 + [_I] * 3 + [_P],
    'nerficg_gs_frontend_bwd': [_P] * 8 + [_FP] + [_P] * 11 + [_I] * 3 +
                               [_P],
    'nerficg_gs_stream_gather': [_P] * 10 + [_I] * 3 + [_L, _L, _P],
    'nerficg_gs_stream_gather_bwd': [_P] * 7 + [_I, _I, _L, _P],
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    candidate = Path(home) / 'bin' / 'nvcc'
    if candidate.is_file():
        return str(candidate)
    found = shutil.which('nvcc')
    if found is None:
        raise KernelError('nvcc not found (CUDA_HOME/bin or PATH); the CUDA '
                          'kernels can only be built on a machine with the '
                          'CUDA toolkit')
    return found


def build_library() -> tuple[Path, float]:
    """Compile csrc/*.cu into build/ unless an identical build exists.
    Returns (library path, seconds spent compiling; 0.0 when reused)."""
    sources = sorted(_CSRC.glob('*.cu'))
    digest = hashlib.sha256(' '.join(_NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob('*.cu*')):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = _BUILD_DIR / f'libnerficg_kernels_{digest.hexdigest()[:16]}.so'
    if out.is_file():
        return out, 0.0
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f'.{os.getpid()}.tmp')
    nvcc = _nvcc()
    compile_flags = [f for f in _NVCC_FLAGS if f != '-shared']
    start = time.perf_counter()
    # One nvcc per source, all started together, then one link.
    objects, procs = [], []
    for src in sources:
        obj = tmp.with_name(f'{tmp.name}.{src.stem}.o')
        objects.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *compile_flags, '-c', '-o', str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for src, proc in zip(sources, procs):
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f'{src.name} ({proc.returncode}):\n{stderr}')
    try:
        if errors:
            raise KernelError('nvcc failed: ' + '\n'.join(errors))
        link = subprocess.run([nvcc, *_NVCC_FLAGS, '-o', str(tmp),
                               *map(str, objects)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise KernelError(f'nvcc link failed ({link.returncode}):\n'
                              f'{link.stderr}')
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    return out, time.perf_counter() - start


def variant_source(name: str, source: Path, overrides: dict) -> Path:
    """``source`` itself, or with each ``constexpr int CONST = ...;`` of
    ``overrides`` set to its value, written to build/ab/<name>.cu."""
    if not overrides:
        return source
    text = source.read_text()
    for const, value in overrides.items():
        text, hits = re.subn(rf'constexpr int {const} = [^;]+;',
                             f'constexpr int {const} = {int(value)};', text)
        if hits != 1:
            raise KernelError(f'{name}: {source} defines {const} {hits} '
                              f'times')
    out = _BUILD_DIR / 'ab' / f'{name}.cu'
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def build_variant(name: str, source: Path, entries: tuple,
                  overrides: Optional[dict] = None,
                  signatures: Optional[dict] = None
                  ) -> tuple[ctypes.CDLL, str]:
    """Compile one kernel source alone into build/ab/lib<name>.so with the
    library's flags and ``-Xptxas -v``, its ``constexpr int`` constants
    first set to ``overrides`` (``variant_source``), and bind those of
    ``entries`` it has, with ``signatures`` where given, else the
    library's. Returns (the loaded library, ptxas's report).

    A build with another block shape or shared-memory budget: how those
    constants are swept, and how a check runs the path that the library's
    own constants leave untaken on its inputs."""
    out = _BUILD_DIR / 'ab' / f'lib{name}.so'
    out.parent.mkdir(parents=True, exist_ok=True)
    compiled = variant_source(name, source, overrides or {})
    proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, '-Xptxas', '-v',
                           f'-I{source.parent}', '-o', str(out),
                           str(compiled)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelError(f'{name}: nvcc failed:\n{proc.stderr}')
    lib = ctypes.CDLL(str(out))
    for entry in entries:
        if hasattr(lib, entry):
            getattr(lib, entry).argtypes = (signatures or {}).get(
                entry, _SIGNATURES.get(entry))
            getattr(lib, entry).restype = ctypes.c_int
    return lib, proc.stderr


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; bind every entry."""
    global _lib
    if _lib is None:
        path, _ = build_library()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.nerficg_error_string.argtypes = [_I]
        lib.nerficg_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = load_library().nerficg_error_string(code).decode()
        raise KernelError(f'{kernel}: launch failed with CUDA error {code} '
                          f'({msg})')


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device (the
    capturing stream while a CUDA graph is captured), read without building
    a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def require_cuda(kernel: str, *tensors: torch.Tensor,
                 dtypes: tuple[torch.dtype, ...]) -> None:
    """Every tensor of the given dtype and contiguous, then all on one CUDA
    device (in that order, so each refusal is reachable without a card)."""
    for t, dtype in zip(tensors, dtypes):
        if t.dtype != dtype:
            raise KernelError(f'{kernel}: expected {dtype}, got {t.dtype}')
        if not t.is_contiguous():
            raise KernelError(f'{kernel}: inputs must be contiguous')
    index = tensors[0].get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != index:
            raise KernelError(f'{kernel}: all inputs must be on one CUDA '
                              f'device, got {t.device} and '
                              f'{tensors[0].device}')
