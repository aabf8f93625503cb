#!/usr/bin/env python3
"""Time the port's CUDA kernels on one card, apart from the host.

Three clocks, each for a different question:

* ``device_ms``: the card's time per call. ``iters`` calls are captured into
  one CUDA graph and its replays timed with CUDA events, so the host's
  launch path is not in the number (a ctypes entry launches on PyTorch's
  current stream, which is the capturing stream during capture).
* ``host_ms``: the wall time per call of ``iters`` back-to-back calls that
  ends in ``synchronize()``: the larger of the host's cost per call and the
  card's. ``enqueue_ms`` is the same loop before the synchronize: the
  host's cost alone.
* ``events_ms``: CUDA events around ``iters`` eager calls (the plain
  versions, which are timed only to show what the kernel replaces).

Run as a script it answers these questions on the card:

  python -m nerficg_torch.scripts.kernel_timing wrappers [--root DIR]
      the host's cost per call of each piece of a kernel wrapper's path
      (the segment gather's), beside ``torch.take`` on the same indices;
      ``--root`` imports ``nerficg_torch`` from another checkout, so two
      trees' wrappers can be timed in one call;
  python -m nerficg_torch.scripts.kernel_timing gs-bwd \\
      --variant NAME=PATH/gs_tiles.cu [--variant ...]
      builds each variant of ``csrc/gs_tiles.cu`` into its own library
      (printing ptxas's registers, shared memory and spills), checks its
      stream backward against the plain version, and times the variants in
      turns (A B ... B A, repeated) on bench.py's 1080p frame and on a
      400x400 frame of the same model;
  python -m nerficg_torch.scripts.kernel_timing xbar-bwd \\
      --variant NAME=PATH/hash_xbar.cu [--variant ...] [--capture FILE]
      builds each variant of ``csrc/hash_xbar.cu`` likewise and times its
      crossbar backward in turns: the table gradient (#11), the position
      gradient (#12) and both (one fused call where the variant has the
      entry, else the two), each checked against the plain versions, on
      uniform positions at 262,144 and 65,536 samples, on a 2^16-entry table
      (the gather path), and on the positions and cotangent of one D-NeRF
      training step (nerficg_torch/configs/dnerf.yaml trained 300 iterations
      on a 400x400 dynamic scene), captured into FILE (default
      build/kernel_timing/dnerf_capture.pt) unless it exists;
  python -m nerficg_torch.scripts.kernel_timing xbar-fwd \\
      --variant NAME=PATH/hash_xbar.cu[:kFwdThreads=N,kFwdLevels=G] ...
      times the crossbar forward (#10) likewise, each variant on the path
      its plan takes, checked against the plain version and the first
      variant: uniform positions at 262,144, 196,608 (a serving chunk) and
      65,536 samples, exact and 4 corners, the captured D-NeRF step's
      positions and a 2^16 table; then both paths over 2,048-262,144
      samples (where the level-resident path starts to pay);
  python -m nerficg_torch.scripts.kernel_timing gs-fwd \\
      --variant NAME=PATH/gs_tiles.cu [--variant ...]
      times the 3DGS forwards (#15 16-wide and packed, #13 on slots) on the
      1080p and 400x400 frames, checked against the first variant bit for
      bit and against the plain versions.
A variant's ``:CONST=VALUE`` list sets those ``constexpr int`` constants of
its source before the build (a copy under build/ab/).

Each also writes its results as JSON under ``build/kernel_timing/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

__all__ = ['device_ms', 'host_ms', 'events_ms', 'gs_model', 'orbit_view',
           'gs_frame', 'gs_pair_counts']

_OUT = Path('build') / 'kernel_timing'


def device_ms(fn, iters: int = 50, replays: int = 3) -> float:
    """Device time of one ``fn()`` in ms: ``iters`` calls captured into one
    CUDA graph, its ``replays`` timed with CUDA events after one untimed
    replay. ``fn`` is called once eagerly first (builds, caches)."""
    import torch
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def host_ms(fn, iters: int = 50) -> tuple[float, float]:
    """(wall ms per call of ``iters`` calls ending in ``synchronize()``,
    ms per call of the same loop before the synchronize), after a warm-up
    call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueued = time.perf_counter()
    torch.cuda.synchronize()
    done = time.perf_counter()
    return (done - start) * 1e3 / iters, (enqueued - start) * 1e3 / iters


def events_ms(fn, iters: int = 50) -> float:
    """Mean time of ``fn()`` in ms between CUDA events around ``iters``
    eager calls, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gs_model(device: str, n: int = 100_000, seed: int = 0):
    """bench.py's ``_make_gs_model`` protocol on the port: n points
    U(-1, 1)^3 with colors U(0, 1) from numpy seed 0, at the library's GS
    defaults (SH degree 4, 16,384-slot capacity steps)."""
    import numpy as np

    from nerficg_torch.core.config import ConfigNode
    from nerficg_torch.data.types import BasicPointCloud
    from nerficg_torch.methods.gaussian_splatting.model import \
        GaussianSplattingModel
    model = GaussianSplattingModel(ConfigNode({'MODEL': {}}), device=device)
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 3)).astype(np.float32) * 2.0 - 1.0
    cols = rng.random((n, 3)).astype(np.float32)
    model.init_from_point_cloud(BasicPointCloud(pts, cols))
    return model


def orbit_view(angle: float, width: int, height: int):
    """bench.py's orbit pose (radius 3, looking at the origin) as a View with
    focal 0.8 * width and a black background."""
    import numpy as np

    from nerficg_torch.cameras.perspective import PerspectiveCamera
    from nerficg_torch.data.types import View
    eye = np.array([3 * np.sin(angle), 0.0, 3 * np.cos(angle)])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = (
        right, np.cross(fwd, right), fwd, eye)
    return View(PerspectiveCamera(width, height, 0.8 * width, 0.8 * width,
                                  width / 2.0, height / 2.0), c2w)


def gs_frame(model, width: int, height: int, packed: bool = False) -> tuple:
    """The compositor's arguments (sorted_mat, starts, counts, tiles_x,
    num_tiles, k = 256) for ``model`` at orbit pose 0, as
    ``rasterize_gaussians`` builds them (6 tiles per Gaussian at most), at
    SH degree 1 as bench.py renders it."""
    import torch

    from nerficg_torch.core.config import ConfigNode
    from nerficg_torch.methods.gaussian_splatting.renderer import \
        GaussianSplattingRenderer
    from nerficg_torch.ops.gs_rasterize import entry_stream
    renderer = GaussianSplattingRenderer(ConfigNode({}), model)
    intrinsics, w2c, cam_pos = renderer.view_constants(
        orbit_view(0.0, width, height))
    with torch.no_grad():
        inputs = renderer.frontend(model.params, w2c, cam_pos, intrinsics,
                                   int(model.active_sh_degree))
        s = entry_stream(**inputs, width=width, height=height,
                         max_tiles_per_gaussian=6, max_per_tile=256,
                         packed_inference=packed)
    return (s['sorted_mat'], s['starts'], s['counts'], s['tiles_x'],
            s['num_tiles'], 256)


def gs_pair_counts(args) -> dict:
    """The (entry, pixel) pairs of a composite of ``args`` = (sorted_mat,
    starts, counts, tiles_x, num_tiles, k), by the plain version's
    geometry: ``valid`` (every entry within min(count, k) at each of its
    tile's 256 pixels), ``walked`` (those of the strips each entry's
    ``strip_reach`` bound reaches: what the culled kernels visit) and
    ``passing`` (alpha > 1/255)."""
    import torch

    from nerficg_torch.ops import gs_tiles_kernel as gtk
    sorted_mat, starts, counts, tiles_x, num_tiles, k = args
    counts = torch.clamp(counts, max=k)
    walked = passing = 0
    strip = torch.arange(gtk.P, device=sorted_mat.device) // 32
    with torch.no_grad():
        for first in range(0, num_tiles, 256):
            last = min(first + 256, num_tiles)
            slots, _ = gtk._slots(sorted_mat, starts, tiles_x, k, first, last)
            origins = gtk._tile_origins(last, tiles_x,
                                        sorted_mat.device)[first:]
            alpha = gtk._alpha_plain(slots, counts[first:last], origins)
            passing += int((alpha > 0).sum())
            inside = torch.arange(k, device=slots.device)[None] < \
                counts[first:last, None]
            reach = gtk._strip_reach_plain(slots, origins)
            walked += int((((reach[..., None] >> strip) & 1).bool()
                           & inside[..., None]).sum())
    return {'valid': int(counts.sum()) * gtk.P, 'walked': walked,
            'passing': passing}


def _card() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def _write(name: str, result: dict) -> None:
    _OUT.mkdir(parents=True, exist_ok=True)
    (_OUT / name).write_text(json.dumps(result, indent=1))


def wrappers(iters: int = 10000, rounds: int = 2) -> dict:
    """Host microseconds per call of each piece of ``seg_gather``'s path at
    the serving chunk's shape (24,576 int32 indices into a (1, 1, 13, 128)
    table), beside ``torch.take``; every piece in turns, ``rounds`` times."""
    import numpy as np
    import torch

    from nerficg_torch.ops import _kernels
    from nerficg_torch.ops.hash_mxu import seg_gather

    rng = np.random.default_rng(1)
    m, rows = 24576, 13
    dev = torch.device('cuda')
    idx = torch.from_numpy(np.sort(rng.integers(0, 1537, (1, m))).astype(
        np.int32)).to(dev)
    table = torch.from_numpy(rng.normal(size=(1, 1, rows, 128)).astype(
        np.float32)).to(dev)
    idx64 = idx[0].long()
    out = torch.empty((1, 1, m), device=dev)
    lib = _kernels.load_library()
    fn = lib.nerficg_seg_gather
    # The same library loaded so that its calls keep the GIL.
    held = ctypes.PyDLL(lib._name).nerficg_seg_gather
    held.argtypes, held.restype = fn.argtypes, fn.restype
    ptrs = (idx.data_ptr(), table.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    pieces = {
        'empty Python call': lambda: None,
        'tensor.device': lambda: table.device,
        'torch.cuda.current_stream(device).cuda_stream':
            lambda: torch.cuda.current_stream(table.device).cuda_stream,
        '_kernels.stream_of': lambda: _kernels.stream_of(table),
        '_kernels.require_cuda (2 tensors)':
            lambda: _kernels.require_cuda('t', idx, table, dtypes=(
                torch.int32, torch.float32)),
        'torch.empty((1, 1, M), dtype, device)':
            lambda: torch.empty((1, 1, m), dtype=torch.float32, device=dev),
        'tensor.new_empty((1, 1, M))': lambda: table.new_empty((1, 1, m)),
        'tensor.data_ptr()': lambda: table.data_ptr(),
        '_kernels.load_library().nerficg_seg_gather':
            lambda: _kernels.load_library().nerficg_seg_gather,
        'ctypes call (launches the kernel)':
            lambda: fn(*ptrs, 1, 1, m, rows, stream),
        'ctypes call, M = 0 (returns before the launch)':
            lambda: fn(*ptrs, 1, 1, 0, rows, stream),
        'ctypes call keeping the GIL (launches)':
            lambda: held(*ptrs, 1, 1, m, rows, stream),
        'ctypes call keeping the GIL, M = 0':
            lambda: held(*ptrs, 1, 1, 0, rows, stream),
        'new_empty + 3 data_ptr + ctypes call (no checks)':
            lambda: fn(idx.data_ptr(), table.data_ptr(),
                       table.new_empty((1, 1, m)).data_ptr(), 1, 1, m, rows,
                       stream),
        'seg_gather (the wrapper)': lambda: seg_gather(idx, table),
        'torch.take (int64 indices)': lambda: torch.take(table, idx64),
    }
    result = {name: [] for name in pieces}
    for _ in range(rounds):
        for name, piece in pieces.items():
            for _ in range(100):
                piece()
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(iters):
                piece()
            torch.cuda.synchronize()
            result[name].append((time.perf_counter() - start) * 1e6 / iters)
    card = _card()
    for name, us in result.items():
        print(f'wrappers: {name}: ' + ', '.join(f'{u:.3f}' for u in us) +
              f' us per call over {iters} calls [{card}]', flush=True)
    device = {'seg_gather': device_ms(lambda: seg_gather(idx, table)),
              'torch.take': device_ms(lambda: torch.take(table, idx64))}
    for name, ms in device.items():
        print(f'wrappers: {name}: {ms * 1e3:.3f} us per call on the card '
              f'(CUDA graph of 50 calls) [{card}]', flush=True)
    return {'card': card, 'iters': iters, 'us_per_call': result,
            'device_ms': device}


def _variant_source(name: str, source: Path, overrides: dict) -> Path:
    """``source`` itself, or with each ``constexpr int NAME = ...;`` of
    ``overrides`` set to its value, written to build/ab/<name>.cu."""
    if not overrides:
        return source
    from nerficg_torch.ops import _kernels
    text = source.read_text()
    for const, value in overrides.items():
        text, hits = re.subn(rf'constexpr int {const} = [^;]+;',
                             f'constexpr int {const} = {int(value)};', text)
        if hits != 1:
            raise ValueError(f'{name}: {source} defines {const} {hits} times')
    out = _kernels._BUILD_DIR / 'ab' / f'{name}.cu'
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def _source_constant(source: Path, const: str) -> int:
    """The value of ``constexpr int const = N;`` in ``source``."""
    return int(re.search(rf'constexpr int {const} = (\d+);',
                         source.read_text()).group(1))


def _build_variant(name: str, source: Path,
                   entries: tuple = ('nerficg_gs_composite_bwd',),
                   overrides: dict | None = None,
                   signatures: dict | None = None
                   ) -> tuple[ctypes.CDLL, str]:
    """Compile one kernel source on its own into build/ab/<name>.so with the
    library's flags and ``-Xptxas -v`` (its constants first set to
    ``overrides``), binding those of ``entries`` it has, with
    ``signatures`` where given; (the loaded library, ptxas's report)."""
    from nerficg_torch.ops import _kernels
    out = _kernels._BUILD_DIR / 'ab' / f'lib{name}.so'
    out.parent.mkdir(parents=True, exist_ok=True)
    compiled = _variant_source(name, source, overrides or {})
    proc = subprocess.run([_kernels._nvcc(), *_kernels._NVCC_FLAGS, '-Xptxas',
                           '-v', f'-I{source.parent}', '-o', str(out),
                           str(compiled)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'{name}: nvcc failed:\n{proc.stderr}')
    lib = ctypes.CDLL(str(out))
    for entry in entries:
        if hasattr(lib, entry):
            getattr(lib, entry).argtypes = (signatures or {}).get(
                entry, _PARENT_SIGNATURES.get(
                    entry, _kernels._SIGNATURES.get(entry)))
            getattr(lib, entry).restype = ctypes.c_int
    return lib, proc.stderr


def gs_bwd(variants: dict[str, tuple], rounds: int = 3) -> dict:
    """Each variant's stream backward on two frames: checked against the
    plain version (rtol 1e-3 / atol 2e-3) and repeat-launch equality, then
    timed in turns (device time, CUDA graph of 20 launches)."""
    import numpy as np
    import torch

    from nerficg_torch.ops import gs_tiles_kernel as gtk

    card = _card()
    libs = {}
    report = {'card': card, 'ptxas': {}, 'frames': {}}
    for name, (source, overrides) in variants.items():
        libs[name], ptxas = _build_variant(name, source, overrides=overrides)
        report['ptxas'][name] = ptxas
        print(f'gs-bwd: {name} ({source} {overrides or ""}) ptxas:\n{ptxas}',
              flush=True)
    model = gs_model('cuda')
    rng = np.random.default_rng(1)
    for width, height in ((1920, 1080), (400, 400)):
        args = gs_frame(model, width, height)
        mat, starts, counts, tiles_x, num_tiles, k = args
        _, tacc = gtk.gs_composite_fwd(*args)
        dout = torch.from_numpy(rng.normal(
            size=(num_tiles, gtk.OUT_ROWS, gtk.P)).astype(np.float32)).cuda()
        want = gtk.gs_composite_bwd_plain(mat, starts, counts, dout, tiles_x,
                                          num_tiles, k)

        def call(lib):
            d = torch.empty_like(mat)
            code = lib.nerficg_gs_composite_bwd(
                mat.data_ptr(), starts.data_ptr(), counts.data_ptr(),
                tacc.data_ptr(), dout.data_ptr(), d.data_ptr(), mat.shape[1],
                num_tiles, tiles_x, k, torch.cuda.current_stream().cuda_stream)
            if code != 0:
                raise RuntimeError(f'launch failed with CUDA error {code}')
            return d

        frame = {'tiles': num_tiles, 'entries': int(counts.clamp(max=k).sum()),
                 'variants': {}}
        for name, lib in libs.items():
            got = call(lib)
            torch.cuda.synchronize()
            frame['variants'][name] = {
                'max_abs_err': float((got - want).abs().max()),
                'close': bool(torch.allclose(got, want, rtol=1e-3,
                                             atol=2e-3)),
                'repeat_equal': bool(torch.equal(got, call(lib))),
                'ms': []}
        order = list(libs) + list(reversed(libs))
        for _ in range(rounds):
            for name in order:
                lib = libs[name]
                frame['variants'][name]['ms'].append(
                    device_ms(lambda: call(lib), iters=20))
        for name, v in frame['variants'].items():
            print(f'gs-bwd {width}x{height} ({num_tiles} tiles, '
                  f'{frame["entries"]} entries within k): {name}: device ms '
                  + ', '.join(f'{t:.4f}' for t in v['ms']) +
                  f' (median {float(np.median(v["ms"])):.4f}); max_abs_err '
                  f'{v["max_abs_err"]:.3e} '
                  f'{"ok" if v["close"] else "MISMATCH"}'
                  f', repeat {"equal" if v["repeat_equal"] else "DIFFERS"} '
                  f'[{card}]', flush=True)
        report['frames'][f'{width}x{height}'] = frame
    return report


def _turns(calls: dict, rounds: int, iters: int = 20) -> dict:
    """Device ms of each named callable, ``rounds`` times in turns (A B ...
    B A)."""
    ms = {name: [] for name in calls}
    order = list(calls) + list(reversed(calls))
    for _ in range(rounds):
        for name in order:
            ms[name].append(device_ms(calls[name], iters=iters))
    return ms


def _median(ts) -> float:
    import numpy as np
    return float(np.median(ts))


def gs_fwd(variants: dict[str, tuple], rounds: int = 3) -> dict:
    """Each variant's forwards, #15 16-wide (with its saved transmittance),
    #15 packed and #13 on the slot windows, on bench.py's 1080p frame and a
    400x400 one of the same model: each output (and the transmittance on
    the chunks a tile composites) against the first variant's with
    ``torch.equal`` and against the plain version (atol 1e-5), then device
    time (CUDA graph of 20 calls) in turns."""
    import torch

    from nerficg_torch.ops import gs_tiles_kernel as gtk

    card = _card()
    libs = {}
    report = {'card': card, 'ptxas': {}, 'frames': {}}
    for name, (source, overrides) in variants.items():
        libs[name], ptxas = _build_variant(
            name, source, ('nerficg_gs_composite_fwd',
                           'nerficg_gs_composite_fwd_packed',
                           'nerficg_gs_tiles_fwd'), overrides)
        report['ptxas'][name] = ptxas
        print(f'gs-fwd: {name} ({source} {overrides or ""}) ptxas:\n{ptxas}',
              flush=True)
    first = next(iter(libs))
    model = gs_model('cuda')

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def checked(code):
        if code != 0:
            raise RuntimeError(f'launch failed with CUDA error {code}')

    for width, height in ((1920, 1080), (400, 400)):
        args16 = gs_frame(model, width, height)
        args8 = gs_frame(model, width, height, packed=True)
        mat, starts, counts, tiles_x, num_tiles, k = args16
        live = gtk.live_chunks(counts, k)
        slots, _ = gtk._slots(mat, starts, tiles_x, k, 0, num_tiles)
        slots = slots.contiguous()
        origins = gtk._tile_origins(num_tiles, tiles_x, mat.device)

        def fwd16(lib):
            out = torch.empty((num_tiles, gtk.OUT_ROWS, gtk.P), device='cuda')
            tacc = torch.empty((num_tiles, gtk.num_chunks(k), gtk.P),
                               device='cuda')
            checked(lib.nerficg_gs_composite_fwd(
                mat.data_ptr(), starts.data_ptr(), counts.data_ptr(),
                out.data_ptr(), tacc.data_ptr(), mat.shape[1], num_tiles,
                tiles_x, k, stream()))
            return out, tacc

        def fwd8(lib):
            m8, s8, c8 = args8[:3]
            out = torch.empty((num_tiles, gtk.OUT_ROWS, gtk.P), device='cuda')
            checked(lib.nerficg_gs_composite_fwd_packed(
                m8.data_ptr(), s8.data_ptr(), c8.data_ptr(), out.data_ptr(),
                m8.shape[1], num_tiles, tiles_x, k, stream()))
            return out

        def slot_fwd(lib):
            out = torch.empty((num_tiles, gtk.SLOT_OUT_ROWS, gtk.P),
                              device='cuda')
            checked(lib.nerficg_gs_tiles_fwd(
                slots.data_ptr(), counts.data_ptr(), origins.data_ptr(),
                out.data_ptr(), num_tiles, k, stream()))
            return out

        want16, want_tacc = gtk.gs_composite_fwd_plain(*args16)
        plain = {'16-wide': want16,
                 'packed': gtk.gs_composite_fwd_plain(*args8,
                                                      save_tacc=False),
                 'slots': gtk.gs_tiles_fwd_plain(slots, counts, origins)}
        frame = {'tiles': num_tiles,
                 'entries': int(counts.clamp(max=k).sum()),
                 'pairs': gs_pair_counts(args16), 'kernels': {}}
        print(f'gs-fwd {width}x{height}: (entry, pixel) pairs '
              f'{frame["pairs"]}', flush=True)
        for kernel, run in (('16-wide', fwd16), ('packed', fwd8),
                            ('slots', slot_fwd)):
            ref = run(libs[first])
            line = {'variants': {}}
            for name, lib in libs.items():
                got = run(lib)
                torch.cuda.synchronize()
                out, ref_out = (got[0], ref[0]) if kernel == '16-wide' else (
                    got, ref)
                entry = {
                    'max_abs_err': float((out - plain[kernel]).abs().max()),
                    'close': bool(torch.allclose(out, plain[kernel], rtol=0,
                                                 atol=1e-5)),
                    'equal_first': bool(torch.equal(out, ref_out))}
                if kernel == '16-wide':
                    entry['close'] &= bool(torch.allclose(
                        got[1][live], want_tacc[live], rtol=0, atol=1e-5))
                    entry['equal_first'] &= bool(torch.equal(got[1][live],
                                                             ref[1][live]))
                line['variants'][name] = entry
            ms = _turns({name: (lambda lib=lib: run(lib))
                         for name, lib in libs.items()}, rounds)
            for name, v in line['variants'].items():
                v['ms'] = ms[name]
                print(f'gs-fwd {width}x{height} {kernel} ({num_tiles} tiles, '
                      f'{frame["entries"]} entries within k): {name}: device '
                      f'ms ' + ', '.join(f'{t:.4f}' for t in v['ms']) +
                      f' (median {_median(v["ms"]):.4f}); max_abs_err '
                      f'{v["max_abs_err"]:.3e} '
                      f'{"ok" if v["close"] else "MISMATCH"}, '
                      f'{"equal to" if v["equal_first"] else "DIFFERS from"} '
                      f'{first} [{card}]', flush=True)
            frame['kernels'][kernel] = line
        report['frames'][f'{width}x{height}'] = frame
    return report


# The crossbar forward's entry before the level-resident path (a parent's
# source), and its backward's entries before the fused one.
_PARENT_XBAR_FWD = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
    ctypes.c_uint, ctypes.c_void_p]


def _xbar_fwd_call(lib, source: Path, table, pos, config, nc, seed,
                   save=False, plan=None):
    """The variant's forward as a callable returning (out, idx, w): through
    ``hash_xbar._launch_fwd`` on ``plan`` (default: ``xbar_fwd_plan`` with
    the variant's own block constants) where the source has the resident
    path, else through its one entry with the parent wrapper's
    allocations."""
    import torch

    from nerficg_torch.ops import hash_xbar as hx
    if 'hash_xbar_fwd_resident_kernel' in source.read_text():
        if plan is None:
            plan = hx.xbar_fwd_plan(
                config, pos.shape[0], *hx._card_limits(pos.get_device()),
                threads=_source_constant(source, 'kFwdThreads'),
                group=_source_constant(source, 'kFwdLevels'))
        return lambda: hx._launch_fwd('xbar-fwd', table, pos, config, nc,
                                      seed, save, lib=lib, plan=plan)
    res_m1, lrows, dense = hx._layout_tensors(config, pos.device)
    levels, n, rows = table.shape[0], pos.shape[0], table.shape[2]

    def call():
        out = torch.empty((n, 2 * levels), device=pos.device)
        idx = w = None
        if save:
            idx = torch.empty((levels, nc or 8, n), dtype=torch.int32,
                              device=pos.device)
            w = torch.empty((levels, nc or 8, n), device=pos.device)
        code = lib.nerficg_hash_xbar_fwd(
            table.data_ptr(), pos.data_ptr(), res_m1.data_ptr(),
            lrows.data_ptr(), dense.data_ptr(), out.data_ptr(),
            None if idx is None else idx.data_ptr(),
            None if w is None else w.data_ptr(), levels, n, rows, nc, seed,
            torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f'launch failed with CUDA error {code}')
        return out, idx, w
    return call


def xbar_fwd(variants: dict[str, tuple], capture: Path,
             rounds: int = 3) -> dict:
    """Each variant's crossbar forward on each input set, on the path its
    plan takes: the output against ``hash_xbar_fwd_plain`` (atol 1e-5) and
    the saved corner streams bit for bit; every output and stream against
    the first variant's with ``torch.equal``; where the variant has both
    paths, the resident path against its gather path, bit for bit; then
    device time (CUDA graph of 20 calls, no saves) in turns. Then, for the
    first variant with both paths, the two paths and the others' plans in
    turns over sample counts from 2,048 to 262,144 (exact corners, uniform
    positions): where the resident path starts to pay."""
    import numpy as np
    import torch

    from nerficg_torch.ops import hash_xbar as hx
    from nerficg_torch.ops.hashgrid import HashGridConfig

    card = _card()
    if not capture.is_file():
        print(f'xbar-fwd: capturing one D-NeRF step into {capture}',
              flush=True)
        capture_dnerf(capture)
    libs, sources = {}, {}
    report = {'card': card, 'ptxas': {}, 'inputs': {}, 'crossover': {}}
    for name, (source, overrides) in variants.items():
        compiled = _variant_source(name, source, overrides)
        resident = 'hash_xbar_fwd_resident_kernel' in compiled.read_text()
        libs[name], ptxas = _build_variant(
            name, source, ('nerficg_hash_xbar_fwd',), overrides,
            None if resident else {'nerficg_hash_xbar_fwd': _PARENT_XBAR_FWD})
        sources[name] = compiled
        report['ptxas'][name] = ptxas
        print(f'xbar-fwd: {name} ({source} {overrides or ""}) ptxas:\n'
              f'{ptxas}', flush=True)
    first = next(iter(libs))
    dev = torch.device('cuda')
    lib_cfg = HashGridConfig(num_levels=16, features_per_level=2,
                             log2_table_size=14, base_resolution=16,
                             target_resolution=2048)
    big_cfg = HashGridConfig(num_levels=16, features_per_level=2,
                             log2_table_size=16, base_resolution=16,
                             target_resolution=2048)
    rng = np.random.default_rng(8)

    def uniform(config, n):
        rows = config.table_size // 128
        return (torch.from_numpy(rng.uniform(-1, 1, (16, 2, rows, 128)).astype(
                    np.float32)).to(dev),
                torch.from_numpy(rng.uniform(0.0, 1 - 1e-6, (n, 3)).astype(
                    np.float32)).to(dev))
    sets = []
    for n in (262144, 196608, 65536):
        inputs = uniform(lib_cfg, n)
        for nc in (0, 4):
            sets.append((f'uniform {n}, {"exact" if nc == 0 else "4 corners"}',
                         inputs, lib_cfg, nc, 0x5EED))
    cap = torch.load(capture, weights_only=False)
    sets.append((f'D-NeRF step {cap["pos"].shape[0]}, '
                 f'{"exact" if cap["n_corners"] == 0 else "stochastic"}',
                 (cap['table'].to(dev), cap['pos'].to(dev)), cap['config'],
                 cap['n_corners'], cap['seed']))
    sets.append(('uniform 262144, exact, 2^16 table (gather path)',
                 uniform(big_cfg, 262144), big_cfg, 0, 0x5EED))

    for label, (table, pos), config, nc, seed in sets:
        want, want_idx, want_w = hx.hash_xbar_fwd_plain(table, pos, config,
                                                        nc, seed, save=True)
        plan = hx.xbar_fwd_plan(config, pos.shape[0])
        entry = {'samples': pos.shape[0], 'n_corners': nc, 'path': plan.path,
                 'tiles': plan.tiles, 'variants': {}}
        ref = _xbar_fwd_call(libs[first], sources[first], table, pos, config,
                             nc, seed, save=True)()
        calls = {}
        for name, lib in libs.items():
            got = _xbar_fwd_call(lib, sources[name], table, pos, config, nc,
                                 seed, save=True)()
            torch.cuda.synchronize()
            v = {'max_abs_err': float((got[0] - want).abs().max()),
                 'close': bool(torch.allclose(got[0], want, rtol=0,
                                              atol=1e-5))
                 and bool(torch.equal(got[1], want_idx))
                 and bool(torch.equal(got[2], want_w)),
                 'equal_first': all(bool(torch.equal(a, b))
                                    for a, b in zip(got, ref)),
                 'max_diff_first': float((got[0] - ref[0]).abs().max())}
            if 'hash_xbar_fwd_resident_kernel' in sources[name].read_text():
                gather = _xbar_fwd_call(
                    lib, sources[name], table, pos, config, nc, seed,
                    save=True, plan=hx.XbarFwdPlan('gather', 0,
                                                   plan.level_rows, 0))()
                v['paths_equal'] = all(bool(torch.equal(a, b))
                                       for a, b in zip(got, gather))
            entry['variants'][name] = v
            calls[name] = _xbar_fwd_call(lib, sources[name], table, pos,
                                         config, nc, seed)
        ms = _turns(calls, rounds)
        for name, v in entry['variants'].items():
            v['ms'] = ms[name]
            paths = '' if 'paths_equal' not in v else (
                ', resident = gather ' + ('bit for bit' if v['paths_equal']
                                          else 'DIFFERS'))
            times = ', '.join(f'{t:.4f}' for t in ms[name])
            print(f'xbar-fwd {label} ({plan.path}, {plan.tiles} tiles): '
                  f'{name}: device ms {times} (median '
                  f'{_median(ms[name]):.4f}); max_abs_err '
                  f'{v["max_abs_err"]:.3e} '
                  f'{"ok" if v["close"] else "MISMATCH"}'
                  f', {"equal to" if v["equal_first"] else "differs from"} '
                  f'{first} (max {v["max_diff_first"]:.3e}){paths} [{card}]',
                  flush=True)
        report['inputs'][label] = entry

    # Where the resident path pays: both paths of the first variant that
    # has them, beside every variant's own plan, over the sample counts.
    both = next((name for name in libs if 'hash_xbar_fwd_resident_kernel'
                 in sources[name].read_text()), None)
    if both is None:
        return report
    table, _ = uniform(lib_cfg, 1)
    for n in (2048, 4096, 8192, 16384, 32768, 65536, 131072, 262144):
        pos = torch.from_numpy(rng.uniform(0.0, 1 - 1e-6, (n, 3)).astype(
            np.float32)).to(dev)
        src = sources[both]
        resident = hx.xbar_fwd_plan(
            lib_cfg, n, *hx._card_limits(0),
            threads=_source_constant(src, 'kFwdThreads'),
            group=_source_constant(src, 'kFwdLevels'), min_samples=0)
        calls = {f'{both} resident ({resident.tiles} tiles)': _xbar_fwd_call(
                     libs[both], src, table, pos, lib_cfg, 0, 0,
                     plan=resident),
                 f'{both} gather': _xbar_fwd_call(
                     libs[both], src, table, pos, lib_cfg, 0, 0,
                     plan=hx.XbarFwdPlan('gather', 0, resident.level_rows,
                                         0))}
        for name, lib in libs.items():
            if name != both:
                calls[name] = _xbar_fwd_call(lib, sources[name], table, pos,
                                             lib_cfg, 0, 0)
        ms = _turns(calls, rounds)
        report['crossover'][n] = ms
        print(f'xbar-fwd crossover, uniform {n}, exact: ' + '; '.join(
            f'{name} {_median(ts):.4f}' for name, ts in ms.items()) +
            f' (device ms, medians of {len(next(iter(ms.values())))}) '
            f'[{card}]', flush=True)
    return report


# The crossbar backward's entries before the fused one (a parent's source).
_PARENT_SIGNATURES = {
    'nerficg_hash_xbar_bwd': [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_uint, ctypes.c_void_p],
    'nerficg_hash_xbar_bwd_pos': [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_uint, ctypes.c_void_p],
}
_XBAR_ENTRIES = ('nerficg_hash_xbar_bwd_fused', *_PARENT_SIGNATURES)


def _xbar_calls(lib, table, pos, g, config, nc, seed) -> dict:
    """The variant's table gradient, position gradient and both, as
    callables: through ``hash_xbar._launch_bwd`` where the variant has the
    fused entry, else through its two entries (with the parent wrappers'
    allocations)."""
    import torch

    from nerficg_torch.ops import hash_xbar as hx
    rows = table.shape[2]
    if hasattr(lib, 'nerficg_hash_xbar_bwd_fused'):
        def run(tab, want_pos):
            return hx._launch_bwd('xbar-bwd', g, pos, table, config, rows, nc,
                                  seed, tab, want_pos, lib=lib)
        return {'tab': lambda: run(True, False)[0],
                'pos': lambda: run(False, True)[1],
                'both': lambda: run(True, True)}
    res_m1, lrows, dense = hx._layout_tensors(config, g.device)
    levels, n = config.num_levels, pos.shape[0]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def tab():
        d = torch.empty((levels, 2, rows, 128), device=g.device)
        code = lib.nerficg_hash_xbar_bwd(
            g.data_ptr(), pos.data_ptr(), res_m1.data_ptr(), lrows.data_ptr(),
            dense.data_ptr(), d.data_ptr(), levels, n, rows, nc, seed,
            stream())
        if code != 0:
            raise RuntimeError(f'launch failed with CUDA error {code}')
        return d

    def dpos():
        d = torch.empty((n, 3), device=g.device)
        code = lib.nerficg_hash_xbar_bwd_pos(
            table.data_ptr(), pos.data_ptr(), g.data_ptr(), res_m1.data_ptr(),
            lrows.data_ptr(), dense.data_ptr(), d.data_ptr(), levels, n, rows,
            nc, seed, stream())
        if code != 0:
            raise RuntimeError(f'launch failed with CUDA error {code}')
        return d
    return {'tab': tab, 'pos': dpos, 'both': lambda: (tab(), dpos())}


def capture_dnerf(path: Path, iterations: int = 300) -> dict:
    """Train nerficg_torch/configs/dnerf.yaml for ``iterations`` on a
    400x400 dynamic textured scene (40 train views, phase 11's), then run
    one more training step and keep what its crossbar backward is given:
    the table, the positions and the cotangent. Saved to ``path``."""
    import tempfile

    import torch

    from nerficg_torch.core.setup import Directories
    from nerficg_torch.data.synthetic import make_dynamic_textured_scene
    from nerficg_torch.ops import hash_xbar as hx
    from nerficg_torch.scripts import train

    config = Path(__file__).resolve().parents[1] / 'configs' / 'dnerf.yaml'
    captured = {}
    with tempfile.TemporaryDirectory(prefix='xbar_capture_') as tmp:
        scene = make_dynamic_textured_scene(Path(tmp) / 'scene',
                                            image_size=400, n_train=40,
                                            n_test=1)
        Directories.base = Path(tmp) / 'output'
        result = train.main(['-c', str(config), f'DATASET.PATH={scene}',
                             f'TRAINING.NUM_ITERATIONS={iterations}',
                             'TRAINING.RENDER_TESTSET=False',
                             'TRAINING.MODEL_NAME=capture'])
        launch = hx._launch_bwd

        def keep(name, g, positions, table, config, rows, n_corners, seed,
                 want_tab, want_pos, lib=None):
            if want_tab and want_pos:
                captured.update(table=table.detach().clone(),
                                pos=positions.clone(), g=g.clone(),
                                config=config, n_corners=n_corners,
                                seed=seed)
            return launch(name, g, positions, table, config, rows, n_corners,
                          seed, want_tab, want_pos, lib)
        hx._launch_bwd = keep
        try:
            result['trainer'].training_iteration(None, iterations)
        finally:
            hx._launch_bwd = launch
    if not captured:
        raise RuntimeError('the D-NeRF step never reached the fused backward')
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(captured, path)
    return captured


def xbar_bwd(variants: dict[str, tuple], capture: Path,
             rounds: int = 3) -> dict:
    """Each variant's crossbar backward on each input set: the table
    gradient against ``hash_xbar_bwd_plain`` (rtol 1e-4 / atol 1e-5 x max,
    atomics), the position gradient against ``hash_xbar_bwd_pos_plain``
    (bit for bit), then device time (CUDA graph of 20 calls) in turns."""
    import numpy as np
    import torch

    from nerficg_torch.ops import hash_xbar as hx
    from nerficg_torch.ops.hashgrid import HashGridConfig

    card = _card()
    if not capture.is_file():
        print(f'xbar-bwd: capturing one D-NeRF step into {capture}',
              flush=True)
        capture_dnerf(capture)
    libs = {}
    report = {'card': card, 'ptxas': {}, 'inputs': {}}
    for name, (source, overrides) in variants.items():
        libs[name], ptxas = _build_variant(name, source, _XBAR_ENTRIES,
                                           overrides)
        report['ptxas'][name] = ptxas
        print(f'xbar-bwd: {name} ({source} {overrides or ""}) ptxas:\n'
              f'{ptxas}', flush=True)
    dev = torch.device('cuda')
    lib_cfg = HashGridConfig(num_levels=16, features_per_level=2,
                             log2_table_size=14, base_resolution=16,
                             target_resolution=2048)
    rng = np.random.default_rng(7)

    def uniform(config, n):
        rows = config.table_size // 128
        return (torch.from_numpy(rng.uniform(-1, 1, (16, 2, rows, 128)).astype(
                    np.float32)).to(dev),
                torch.from_numpy(rng.uniform(0.2, 0.8, (n, 3)).astype(
                    np.float32)).to(dev),
                torch.from_numpy(rng.normal(size=(n, 32)).astype(
                    np.float32)).to(dev))
    sets = []
    for n in (262144, 65536):
        inputs = uniform(lib_cfg, n)
        for nc in (0, 4):
            sets.append((f'uniform {n}, {"exact" if nc == 0 else "4 corners"}',
                         inputs, lib_cfg, nc, 0x5EED))
    big_cfg = HashGridConfig(num_levels=16, features_per_level=2,
                             log2_table_size=16, base_resolution=16,
                             target_resolution=2048)
    sets.append(('uniform 262144, exact, 2^16 table (gather path)',
                 uniform(big_cfg, 262144), big_cfg, 0, 0x5EED))
    cap = torch.load(capture, weights_only=False)
    cap_inputs = tuple(cap[k].to(dev) for k in ('table', 'pos', 'g'))
    mode = 'exact' if cap['n_corners'] == 0 else 'stochastic'
    sets.append((f'D-NeRF step {cap["pos"].shape[0]}, {mode}', cap_inputs,
                 cap['config'], cap['n_corners'], cap['seed']))
    # The same samples in a random order: the same work without the ray
    # order's shared corners, so the difference is what collisions cost.
    order = torch.from_numpy(rng.permutation(cap['pos'].shape[0])).to(dev)
    sets.append((f'D-NeRF step {cap["pos"].shape[0]}, {mode}, samples '
                 'shuffled', (cap_inputs[0], cap_inputs[1][order].contiguous(),
                              cap_inputs[2][order].contiguous()),
                 cap['config'], cap['n_corners'], cap['seed']))

    for label, (table, pos, g), config, nc, seed in sets:
        want_tab = hx.hash_xbar_bwd_plain(g, pos, config, table.shape[2], nc,
                                          seed)
        want_pos = hx.hash_xbar_bwd_pos_plain(table, pos, g, config, nc,
                                              seed)
        zero = float((g.reshape(g.shape[0], -1, 2) == 0).all(-1).double()
                     .mean())
        plan = hx.xbar_bwd_plan(config, pos.shape[0])
        entry = {'samples': pos.shape[0], 'n_corners': nc,
                 'zero_cotangent_share': zero, 'path': plan.path,
                 'tiles': plan.tiles, 'variants': {}}
        calls = {}
        for name, lib in libs.items():
            calls[name] = _xbar_calls(lib, table, pos, g, config, nc, seed)
            dtab, dpos = calls[name]['both']()
            torch.cuda.synchronize()
            atol = 1e-5 * float(want_tab.abs().max())
            entry['variants'][name] = {
                'tab_err': float((dtab - want_tab).abs().max()),
                'tab_close': bool(torch.allclose(dtab, want_tab, rtol=1e-4,
                                                 atol=atol)),
                'tab_only_close': bool(torch.allclose(
                    calls[name]['tab'](), want_tab, rtol=1e-4, atol=atol)),
                'pos_equal': bool(torch.equal(dpos, want_pos)),
                'pos_only_equal': bool(torch.equal(calls[name]['pos'](),
                                                   want_pos)),
                'pos_err': float((dpos - want_pos).abs().max()),
                'ms': {'tab': [], 'pos': [], 'both': []}}
        order = list(libs) + list(reversed(libs))
        for _ in range(rounds):
            for name in order:
                for what, fn in calls[name].items():
                    entry['variants'][name]['ms'][what].append(
                        device_ms(fn, iters=20))
        for name, v in entry['variants'].items():
            times = '; '.join(
                f'{what} ' + ', '.join(f'{t:.4f}' for t in ts) +
                f' (median {float(np.median(ts)):.4f})'
                for what, ts in v['ms'].items())
            ok = v['tab_close'] and v['tab_only_close'] and v['pos_equal'] \
                and v['pos_only_equal']
            print(f'xbar-bwd {label} ({plan.path}, zero-cotangent share '
                  f'{zero:.3f}): {name}: device ms {times}; table err '
                  f'{v["tab_err"]:.3e}, dpos err {v["pos_err"]:.3e} '
                  f'{"ok" if ok else "MISMATCH"} [{card}]', flush=True)
        report['inputs'][label] = entry
    return report


def _parse_variant(spec: str) -> tuple[str, tuple[Path, dict]]:
    """NAME=PATH[:CONST=VALUE,...] -> (NAME, (PATH, {CONST: VALUE}))."""
    name, rest = spec.split('=', 1)
    path, _, sets = rest.partition(':')
    overrides = dict(item.split('=', 1) for item in sets.split(',') if item)
    return name, (Path(path), overrides)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('what', choices=('wrappers', 'gs-bwd', 'gs-fwd',
                                         'xbar-bwd', 'xbar-fwd'))
    parser.add_argument('--root', default=None,
                        help='import nerficg_torch from this checkout')
    parser.add_argument('--variant', action='append', default=[],
                        help='NAME=PATH[:CONST=VALUE,...] of a gs_tiles.cu '
                        '(gs-bwd, gs-fwd) or a hash_xbar.cu (xbar-bwd, '
                        'xbar-fwd), its constexpr int CONSTs set to VALUEs')
    parser.add_argument('--capture', default=str(_OUT / 'dnerf_capture.pt'),
                        help='the captured D-NeRF step (xbar-bwd, xbar-fwd)')
    args = parser.parse_args(argv)
    if args.root is not None:
        sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        sys.exit('kernel_timing: needs a CUDA card')
    if args.what == 'wrappers':
        tag = Path(args.root).name if args.root else 'this'
        _write(f'wrappers_{tag}.json', wrappers())
        return
    variants = dict(map(_parse_variant, args.variant))
    if args.what == 'gs-bwd':
        _write('gs_bwd_ab.json', gs_bwd(variants))
    elif args.what == 'gs-fwd':
        _write('gs_fwd_ab.json', gs_fwd(variants))
    elif args.what == 'xbar-bwd':
        _write('xbar_bwd_ab.json', xbar_bwd(variants, Path(args.capture)))
    else:
        _write('xbar_fwd_ab.json', xbar_fwd(variants, Path(args.capture)))


if __name__ == '__main__':
    main()
