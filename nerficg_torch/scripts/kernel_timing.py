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
      (the segment gather's), beside ``torch.take`` on the same indices,
      and of the segment scatter-add's wrapper beside ``index_add_``;
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
      bit and against the plain versions;
  python -m nerficg_torch.scripts.kernel_timing seg-scatter \\
      --variant NAME=PATH/seg_ops.cu [--variant ...]
      times the segment scatter-add (#7) likewise, device and host time per
      call beside ``index_add_``: phase 2's serving chunk (sorted ray ids,
      F = 5 and 1), unsorted ids with out-of-range entries, signed values,
      training-sized calls and planes too large for the fused path; then
      each variant's fused path (a cluster size per variant:
      ``:kScatterCluster=N``) and the atomic path over M, and both over
      the planes' size;
  python -m nerficg_torch.scripts.kernel_timing cell-bwd \\
      --variant NAME=PATH/hash_cell.cu [--variant ...]
      times the cell table gradient (#9) likewise on phase 2's 262,144
      morton-sorted samples of the 2^19 parity table and on the same samples
      unsorted, printing each level's window widths and the share of blocks
      on each path; then levels forced onto the global path one at a time
      (shared-memory budgets are variants: ``:kWinRows=N``);
  python -m nerficg_torch.scripts.kernel_timing cell-fwd \\
      --variant NAME=PATH/hash_cell.cu[:kFwdThreads=N] ...
  python -m nerficg_torch.scripts.kernel_timing window-fwd \\
      --variant NAME=PATH/hash_window.cu[:kFwdWinRows=N] ...
      time the exact windowed forwards, the cell encode (#8) on phase 2's
      262,144 samples of the 2^19 parity table, a serving chunk's 196,608
      and an occupancy-grid refresh's 4,194,304 cells, the window encode
      (#1) on a serving chunk's 196,608 of the library's 2^14 table,
      morton-sorted and unsorted, every output held to the first variant's
      bit for bit, then each level alone; the
      window encode also over 8,192-131,072 samples and its stochastic
      forward (4 corners, saved streams held to the first variant's);
  python -m nerficg_torch.scripts.kernel_timing window-bwd \\
      --variant NAME=PATH/hash_window.cu[:kBwdLevelBlocks=N] ...
      times the window table gradients: the exact one (#2) from positions,
      phase 2's 65,536 morton-sorted samples x 8 corners on the 2^14
      table, 262,144 samples, unsorted samples and a 2^16 table (the global
      path); then the cached one (#3) from the stochastic forward's saved
      streams, 65,536 x 4 corners, 262,144, 1 and 2 corners, unsorted and
      the 2^16 table; each variant against the plain version, beside
      ``index_add_`` of the precomputed products;
  python -m nerficg_torch.scripts.kernel_timing probe
      times the marcher's occupancy probe as ``march_rays`` calls it: the
      parent's composition (PyTorch operations, then ``block_probe_cells``)
      against the one-launch world-plane kernel at the candidate pass's
      344,064 probes and a serving chunk's 196,608 samples, cascaded and
      over one grid (device and host ms, the card's operations per call),
      how the card divides a tensor by a Python float, then the plain
      cascade and cells on the card against the CPU at every cascade and
      cell boundary +-1 ulp.
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
           'gs_frame', 'gs_pair_counts', 'boundary_values', 'probe_points',
           'index_add_call', 'exact_index_add_call']

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
    table), beside ``torch.take``, and of the segment scatter-add's whole
    wrapper at the chunk's (1, 5, 24,576) -> (1, 5, 13, 128); every piece
    in turns, ``rounds`` times."""
    import numpy as np
    import torch

    from nerficg_torch.ops import _kernels
    from nerficg_torch.ops.hash_mxu import seg_gather, seg_scatter_add

    rng = np.random.default_rng(1)
    m, rows = 24576, 13
    dev = torch.device('cuda')
    idx = torch.from_numpy(np.sort(rng.integers(0, 1537, (1, m))).astype(
        np.int32)).to(dev)
    table = torch.from_numpy(rng.normal(size=(1, 1, rows, 128)).astype(
        np.float32)).to(dev)
    idx64 = idx[0].long()
    vals = torch.from_numpy(rng.uniform(0, 1, (1, 5, m)).astype(
        np.float32)).to(dev)
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
        'seg_scatter_add (the wrapper), F = 5':
            lambda: seg_scatter_add(idx, vals, rows),
        'torch.zeros + index_add_, F = 5':
            lambda: torch.zeros((5, rows * 128), device=dev).index_add_(
                1, idx64, vals[0]),
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
              'torch.take': device_ms(lambda: torch.take(table, idx64)),
              'seg_scatter_add': device_ms(
                  lambda: seg_scatter_add(idx, vals, rows))}
    for name, ms in device.items():
        print(f'wrappers: {name}: {ms * 1e3:.3f} us per call on the card '
              f'(CUDA graph of 50 calls) [{card}]', flush=True)
    return {'card': card, 'iters': iters, 'us_per_call': result,
            'device_ms': device}


def _variant_source(name: str, source: Path, overrides: dict) -> Path:
    """``_kernels.variant_source``: the source with ``overrides`` set."""
    from nerficg_torch.ops import _kernels
    return _kernels.variant_source(name, source, overrides)


def _source_constant(source: Path, const: str) -> int:
    """The value of ``constexpr int const = N;`` in ``source``."""
    return int(re.search(rf'constexpr int {const} = (\d+);',
                         source.read_text()).group(1))


def _build_variant(name: str, source: Path,
                   entries: tuple = ('nerficg_gs_composite_bwd',),
                   overrides: dict | None = None,
                   signatures: dict | None = None
                   ) -> tuple[ctypes.CDLL, str]:
    """``_kernels.build_variant``, binding a parent's entries by
    ``_PARENT_SIGNATURES`` unless ``signatures`` gives them; (the loaded
    library, ptxas's report)."""
    from nerficg_torch.ops import _kernels
    return _kernels.build_variant(
        name, source, entries, overrides,
        {**_PARENT_SIGNATURES, **(signatures or {})})


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


# The segment scatter's and the cell backward's entries before this
# design's (a parent's source).
_PARENT_SEG_SCATTER = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]
_PARENT_CELL_BWD = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]


def _checked(code: int) -> None:
    if code != 0:
        raise RuntimeError(f'launch failed with CUDA error {code}')


def _scatter_call(lib, fusable: bool, idx, g, rows, path=None):
    """The variant's scatter as a callable: the wrapper's allocation and
    the ctypes call, on ``path`` ('fused' or 'atomic'; default the plan's)
    where the source's entry takes a path."""
    import torch

    from nerficg_torch.ops import hash_mxu as hm
    levels, feats, m = g.shape
    fused = (path or hm.seg_scatter_plan(feats, m, rows)) == 'fused'

    def call():
        out = g.new_empty((levels, feats, rows, 128))
        stream = torch.cuda.current_stream().cuda_stream
        if fusable:
            _checked(lib.nerficg_seg_scatter_add(
                idx.data_ptr(), g.data_ptr(), out.data_ptr(), levels, feats,
                m, rows, int(fused), stream))
        else:
            _checked(lib.nerficg_seg_scatter_add(
                idx.data_ptr(), g.data_ptr(), out.data_ptr(), levels, feats,
                m, rows, stream))
        return out
    return call


def _parent_scatter_wrapper(lib, idx, g, rows):
    """The parent tree's ``seg_scatter_add`` body on ``lib``: the same
    checks, allocation and single ctypes call (its entry zeroes the output
    with cudaMemsetAsync, then launches)."""
    import torch

    from nerficg_torch.ops import _kernels
    from nerficg_torch.ops import hash_mxu as hm

    def call():
        name = 'seg_scatter_add'
        if g.ndim != 3:
            raise RuntimeError(f'{name}: g must be (L, F, M)')
        levels, feats, m = g.shape
        hm._check_idx(name, idx, levels)
        if idx.shape[1] != m:
            raise RuntimeError(f'{name}: idx and g disagree on M')
        _kernels.require_cuda(name, idx, g,
                              dtypes=(torch.int32, torch.float32))
        out = g.new_empty((levels, feats, rows, 128))
        _checked(lib.nerficg_seg_scatter_add(
            idx.data_ptr(), g.data_ptr(), out.data_ptr(), levels, feats, m,
            rows, _kernels.stream_of(g)))
        call.launches += 1
        return out
    call.launches = 0
    return call


def seg_scatter(variants: dict[str, tuple], rounds: int = 3) -> dict:
    """Each variant's segment scatter-add (#7) on phase 2's serving chunk
    (24,576 sorted ray ids of 1,536 rays, F = 5 and 1, 13 rows), on the
    same shape with unsorted ids, a tenth of them out of range, on a
    training-sized call (65,536 sorted ids of 4,096 rays, F = 5), on
    signed values, and on planes past SCATTER_FUSED_MAX_BYTES (the atomic
    path): each checked against the plain version (within 1e-5 of the sum
    of |g| per entry, plus 1e-6) and the first variant, then device time
    (CUDA graph of 50 calls) and host time per call (50 calls ending in a
    synchronize) in turns, beside ``torch.zeros(...).index_add_`` on the
    same ids where they are all in range; this tree's wrapper against the
    parent's wrapper body, host time per call. Then each variant with the
    fused path (a cluster size per variant: ``:kScatterCluster=N``) and the
    first one's atomic path in turns over M (where the fused path starts to
    pay), and the fused path against the atomic path over the planes' size
    (where a cluster's own zeroing stops paying)."""
    import numpy as np
    import torch

    from nerficg_torch.ops import hash_mxu as hm

    card = _card()
    libs, fusable = {}, {}
    report = {'card': card, 'ptxas': {}, 'inputs': {}, 'over_m': {}}
    for name, (source, overrides) in variants.items():
        compiled = _variant_source(name, source, overrides)
        fusable[name] = 'int fused' in compiled.read_text()
        libs[name], ptxas = _build_variant(
            name, source, ('nerficg_seg_scatter_add',), overrides,
            None if fusable[name] else
            {'nerficg_seg_scatter_add': _PARENT_SEG_SCATTER})
        report['ptxas'][name] = ptxas
        print(f'seg-scatter: {name} ({source} {overrides or ""}) ptxas:\n'
              f'{ptxas}', flush=True)
    first = next(iter(libs))
    dev = torch.device('cuda')
    rng = np.random.default_rng(1)

    def inputs(m, rays, feats, sort=True, out_of_range=0.0, rows=None,
               low=0.0):
        rows = rows or (rays + 1 + 127) // 128
        ids = rng.integers(0, rays + 1, m)
        if sort:
            ids = np.sort(ids)
        bad = rng.uniform(size=m) < out_of_range
        ids[bad] = rng.choice([-1, -1000, rows * 128, rows * 128 + 7],
                              int(bad.sum()))
        return (torch.from_numpy(ids.astype(np.int32)[None]).to(dev),
                torch.from_numpy(rng.uniform(low, 1, (1, feats, m)).astype(
                    np.float32)).to(dev), rows)

    def close(got, idx, g, rows):
        # Within 1e-5 of the sum of |g| per entry: rtol 1e-5 / atol 1e-6
        # where the values share a sign, and scaled where sums cancel.
        want = hm.seg_scatter_add_plain(idx, g, rows)
        scale = hm.seg_scatter_add_plain(idx, g.abs(), rows)
        return bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())
    sets = [('serving chunk, sorted, F = 5', inputs(24576, 1536, 5)),
            ('serving chunk, sorted, F = 1', inputs(24576, 1536, 1)),
            ('serving chunk, unsorted, 10% negative or past the end, F = 5',
             inputs(24576, 1536, 5, sort=False, out_of_range=0.1)),
            ('serving chunk, sorted, signed values, F = 5',
             inputs(24576, 1536, 5, low=-1.0)),
            ('training step, 8,192 sorted, 512 rays, F = 5',
             inputs(8192, 512, 5)),
            ('training, 65,536 sorted, 4,096 rays, F = 5',
             inputs(65536, 4096, 5)),
            ('past the fused planes, 24,576 sorted, 65,536 rays, F = 5',
             inputs(24576, 65536, 5))]
    for label, (idx, g, rows) in sets:
        want = hm.seg_scatter_add_plain(idx, g, rows)
        path = hm.seg_scatter_plan(g.shape[1], g.shape[2], rows)
        entry = {'m': g.shape[2], 'feats': g.shape[1], 'rows': rows,
                 'path': path, 'variants': {}}
        calls = {name: _scatter_call(lib, fusable[name], idx, g, rows)
                 for name, lib in libs.items()}
        ref = calls[first]()
        for name, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            entry['variants'][name] = {
                'max_abs_err': float((got - want).abs().max()),
                'close': close(got, idx, g, rows),
                'close_first': bool(
                    ((got - ref).abs() <= 2e-5 * hm.seg_scatter_add_plain(
                        idx, g.abs(), rows) + 2e-6).all()),
                'ms': [], 'host_ms': []}
        in_range = bool(((idx >= 0) & (idx < rows * 128)).all())
        if in_range:
            idx64 = idx[0].long()
            calls['index_add_'] = lambda idx64=idx64, g=g, rows=rows: \
                torch.zeros((g.shape[1], rows * 128), device=dev).index_add_(
                    1, idx64, g[0])
            entry['variants']['index_add_'] = {'ms': [], 'host_ms': []}
        order = list(calls) + list(reversed(calls))
        for _ in range(rounds):
            for name in order:
                v = entry['variants'][name]
                v['ms'].append(device_ms(calls[name]))
                v['host_ms'].append(host_ms(calls[name])[0])
        for name, v in entry['variants'].items():
            check = '' if name == 'index_add_' else (
                f'; max_abs_err {v["max_abs_err"]:.3e} '
                f'{"ok" if v["close"] else "MISMATCH"}, '
                f'{"close to" if v["close_first"] else "DIFFERS from"} '
                f'{first}')
            print(f'seg-scatter {label} ({path}): {name}: device ms ' +
                  ', '.join(f'{t:.4f}' for t in v['ms']) +
                  f' (median {_median(v["ms"]):.4f}); host ms per call ' +
                  ', '.join(f'{t:.4f}' for t in v['host_ms']) +
                  f' (median {_median(v["host_ms"]):.4f}){check} [{card}]',
                  flush=True)
        report['inputs'][label] = entry

    # The host's cost of a whole wrapper call at the serving chunk (F = 5):
    # this tree's seg_scatter_add against, for each variant without the
    # path argument, the parent tree's wrapper body (its checks, its
    # allocation and its one ctypes call) around that variant's library;
    # in turns, ``rounds`` times, 2,000 calls each ending in a synchronize.
    idx, g, rows = sets[0][1]
    wrapped = {'this tree': lambda: hm.seg_scatter_add(idx, g, rows)}
    for name, lib in libs.items():
        if not fusable[name]:
            wrapped[f'{name} (parent wrapper)'] = _parent_scatter_wrapper(
                lib, idx, g, rows)
    report['wrapper_host_ms'] = {name: [] for name in wrapped}
    for _ in range(rounds):
        for name in list(wrapped) + list(reversed(wrapped)):
            report['wrapper_host_ms'][name].append(
                host_ms(wrapped[name], iters=2000)[0])
    for name, ts in report['wrapper_host_ms'].items():
        print(f'seg-scatter wrapper, serving chunk, F = 5: {name}: host ms '
              f'per call ' + ', '.join(f'{t:.4f}' for t in ts) +
              f' (median {_median(ts):.4f}) [{card}]', flush=True)

    # Where the fused path starts to pay: each fused variant (its own
    # cluster size) and the first one's atomic path over M (sorted ids of
    # 1,536 rays, F = 5); then the fused path and the atomic path over the
    # planes' rows (24,576 sorted ids of 1,536 rays, F = 5, the rest of
    # the planes untouched: where a cluster's own zeroing stops paying).
    fused = [name for name in libs if fusable[name]]
    if not fused:
        return report

    def sweep(idx, g, rows, what):
        calls = {f'{name} fused': _scatter_call(libs[name], True, idx, g,
                                                rows, 'fused')
                 for name in fused}
        calls[f'{fused[0]} atomic'] = _scatter_call(libs[fused[0]], True, idx,
                                                    g, rows, 'atomic')
        for name, call in calls.items():
            if not close(call(), idx, g, rows):
                raise RuntimeError(f'seg-scatter: {name} at {what} '
                                   'disagrees with the plain version')
        return _turns(calls, rounds, iters=50)
    for m in (4096, 8192, 12288, 16384, 20480, 24576, 65536, 196608):
        idx, g, rows = inputs(m, 1536, 5)
        ms = report['over_m'][m] = sweep(idx, g, rows, f'M = {m}')
        print(f'seg-scatter over M, M = {m}, F = 5 (plan: '
              f'{hm.seg_scatter_plan(5, m, rows)}): ' + '; '.join(
                  f'{name} {_median(ts):.4f}' for name, ts in ms.items()) +
              f' (device ms, medians of {rounds * 2}) [{card}]', flush=True)
    report['planes'] = {}
    for rows in (13, 129, 409, 1025, 4097):
        idx, g, rows = inputs(24576, 1536, 5, rows=rows)
        ms = report['planes'][rows] = sweep(idx, g, rows, f'{rows} rows')
        print(f'seg-scatter planes, {rows} rows x F = 5 ({rows * 2560} '
              f'bytes; plan: {hm.seg_scatter_plan(5, 24576, rows)}): ' +
              '; '.join(f'{name} {_median(ts):.4f}'
                        for name, ts in ms.items()) +
              f' (device ms, medians of {rounds * 2}) [{card}]', flush=True)
    return report


def _cell_bwd_call(lib, new: bool, g, pos, lo, win, config, rows,
                   global_levels=()):
    """The variant's cell backward as a callable: the wrapper's allocation
    and the ctypes call, with ``global_levels`` forced onto the global path
    where the source has the window-resident path."""
    import torch

    from nerficg_torch.ops import hash_cell as hc
    res, dense, bscale, rpb, rsh = hc._layout_tensors(config, g.device)
    levels, n = config.num_levels, pos.shape[0]
    nsb = n // (hc.CELL_SUB_BLOCK * 128)
    mask = sum(1 << lv for lv in global_levels)

    def call():
        d = torch.empty((levels, 2, rows, 128), device=g.device)
        common = (g.data_ptr(), pos.data_ptr(), lo.data_ptr(), win.data_ptr(),
                  res.data_ptr(), dense.data_ptr(), bscale.data_ptr(),
                  rpb.data_ptr(), rsh.data_ptr())
        stream = torch.cuda.current_stream().cuda_stream
        if new:
            _checked(lib.nerficg_hash_cell_bwd(
                *common, d.data_ptr(), levels, n, nsb, rows, mask, stream))
        else:
            _checked(lib.nerficg_hash_cell_bwd(
                *common, d.data_ptr(), levels, n, nsb, rows, stream))
        return d
    return call


# Upper edges (base rows) of the window-width histogram's bins.
WIN_BINS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)


def cell_window_report(win, win_rows: int | None = None) -> dict:
    """Per level: the sub-blocks' window widths (min, median, max, in base
    rows, and how many fall in each bin up to WIN_BINS' edges, the last
    open) and the share of (sub-block, level) blocks on the
    window-resident path (``cell_bwd_paths``; windows of at most
    ``win_rows`` base rows where given, as a ``:kWinRows=N`` variant
    builds); and that share over all levels."""
    import torch

    from nerficg_torch.ops import hash_cell as hc
    on = (hc.cell_bwd_paths(win) if win_rows is None
          else win <= win_rows)
    w = win.cpu().float()
    edges = torch.tensor(WIN_BINS, dtype=torch.float32)
    levels = [{'min': int(w[lv].min()), 'median': float(w[lv].median()),
               'max': int(w[lv].max()),
               'histogram': torch.bincount(
                   torch.bucketize(w[lv], edges),
                   minlength=len(WIN_BINS) + 1).tolist(),
               'resident_share': float(on[lv].float().mean())}
              for lv in range(win.shape[0])]
    return {'levels': levels, 'resident_share': float(on.float().mean())}


def cell_bwd(variants: dict[str, tuple], rounds: int = 3) -> dict:
    """Each variant's cell table gradient (#9) on phase 2's inputs (262,144
    samples uniform in [0.2, 0.8]^3, morton-sorted, the (16, 2, 4096, 128)
    table of configs/ingp_parity.yaml) and on the same samples unsorted
    (wide windows): the windows' widths per level and the share of blocks
    on each path, each variant against the plain version (rtol 1e-4 / atol
    1e-5 x max, atomics), then device time (CUDA graph of 20 calls) in
    turns, and the first variant with the window-resident path with every
    level forced onto the global path. Then that variant with one level
    forced at a time, and each variant's time per level. Shared-memory
    budgets are variants: ``NAME=PATH:kWinRows=N``."""
    import numpy as np
    import torch

    from nerficg_torch.ops import hash_cell as hc
    from nerficg_torch.ops.hash_window import morton_sort_keys
    from nerficg_torch.ops.hashgrid import HashGridConfig

    card = _card()
    libs, new = {}, {}
    report = {'card': card, 'ptxas': {}, 'inputs': {}, 'forced': {},
              'levels': {}}
    config = HashGridConfig(num_levels=16, features_per_level=2,
                            log2_table_size=19, base_resolution=16,
                            target_resolution=2048, anchor_stride=8)
    for name, (source, overrides) in variants.items():
        compiled = _variant_source(name, source, overrides)
        new[name] = 'global_mask' in compiled.read_text()
        libs[name], ptxas = _build_variant(
            name, source, ('nerficg_hash_cell_bwd',), overrides,
            None if new[name] else {'nerficg_hash_cell_bwd':
                                    _PARENT_CELL_BWD})
        report['ptxas'][name] = ptxas
        print(f'cell-bwd: {name} ({source} {overrides or ""}) ptxas:\n'
              f'{ptxas}', flush=True)
    dev = torch.device('cuda')
    rows, n = 4096, 262144
    rng = np.random.default_rng(1)
    pos = torch.from_numpy(rng.uniform(0.2, 0.8, (n, 3)).astype(
        np.float32)).to(dev)
    pos = pos[torch.sort(morton_sort_keys(pos), stable=True).indices]
    pos = pos.contiguous()
    g = torch.from_numpy(rng.normal(size=(32, n)).astype(np.float32)).to(dev)
    shuffled = pos[torch.from_numpy(rng.permutation(n)).to(dev)].contiguous()
    def scatter_ok(a, b):
        return bool(torch.allclose(a, b, rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max())))

    both = next((name for name in libs if new[name]), None)
    for label, p in (('262,144 morton-sorted', pos),
                     ('262,144 unsorted', shuffled)):
        lo, win = hc.cell_window_bases(p, config)
        want = hc.hash_cell_bwd_plain(g, p, lo, win, config, rows)
        windows = cell_window_report(win)
        entry = {'windows': windows, 'variants': {}}
        for name, (source, overrides) in variants.items():
            if new[name] and 'kWinRows' in overrides:
                share = cell_window_report(
                    win, int(overrides['kWinRows']))['resident_share']
                print(f'cell-bwd {label}: {name}: share resident at '
                      f'{overrides["kWinRows"]} rows {share:.3f}', flush=True)
        print(f'cell-bwd {label}: windows per level (base rows min/median/'
              f'max, share resident at {hc.BWD_WIN_ROWS} rows): ' +
              '; '.join(f'{lv}: {w["min"]}/{w["median"]:g}/{w["max"]} '
                        f'{w["resident_share"]:.3f}'
                        for lv, w in enumerate(windows['levels'])) +
              f'; all levels {windows["resident_share"]:.3f}', flush=True)
        print(f'cell-bwd {label}: window widths per level, sub-blocks in '
              f'base-row bins <= {", ".join(map(str, WIN_BINS))}, more: ' +
              '; '.join(f'{lv}: {w["histogram"]}'
                        for lv, w in enumerate(windows['levels'])),
              flush=True)
        calls = {name: _cell_bwd_call(lib, new[name], g, p, lo, win, config,
                                      rows) for name, lib in libs.items()}
        if both is not None:
            calls[f'{both}, all levels global'] = _cell_bwd_call(
                libs[both], True, g, p, lo, win, config, rows, range(16))
        for name, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            entry['variants'][name] = {
                'max_abs_err': float((got - want).abs().max()),
                'close': scatter_ok(got, want)}
        ms = _turns(calls, rounds)
        for name, v in entry['variants'].items():
            v['ms'] = ms[name]
            print(f'cell-bwd {label}: {name}: device ms ' +
                  ', '.join(f'{t:.4f}' for t in ms[name]) +
                  f' (median {_median(ms[name]):.4f}); max_abs_err '
                  f'{v["max_abs_err"]:.3e} '
                  f'{"ok" if v["close"] else "MISMATCH"} [{card}]',
                  flush=True)
        report['inputs'][label] = entry

    if both is None:
        return report
    lo, win = hc.cell_window_bases(pos, config)
    want = hc.hash_cell_bwd_plain(g, pos, lo, win, config, rows)
    calls = {f'level {lv} global': _cell_bwd_call(
                 libs[both], True, g, pos, lo, win, config, rows, (lv,))
             for lv in range(16)}
    for label, call in calls.items():
        if not scatter_ok(call(), want):
            raise RuntimeError(f'cell-bwd: {label} disagrees with the plain '
                               'version')
    ms = _turns(calls, rounds)
    for lv in range(16):
        label = f'level {lv} global'
        share = float(hc.cell_bwd_paths(win, (lv,)).float().mean())
        report['forced'][label] = {'ms': ms[label], 'resident_share': share}
        print(f'cell-bwd {both} {label}: device ms ' +
              ', '.join(f'{t:.4f}' for t in ms[label]) +
              f' (median {_median(ms[label]):.4f}), resident share '
              f'{share:.3f} [{card}]', flush=True)

    # Where the time goes by level: each variant with the cotangent zero on
    # every level but one (a warp whose cotangents are all 0 skips the
    # level, in the parent as here), and on every level (the memset and the
    # launch alone).
    for lv in [*range(16), None]:
        g_lv = torch.zeros_like(g)
        if lv is not None:
            g_lv[2 * lv:2 * lv + 2] = g[2 * lv:2 * lv + 2]
        calls = {name: _cell_bwd_call(lib, new[name], g_lv, pos, lo, win,
                                      config, rows)
                 for name, lib in libs.items()}
        ms = _turns(calls, 1)
        tag = 'no level' if lv is None else f'level {lv}'
        report['levels'][tag] = ms
        print(f'cell-bwd {tag} alone: ' + '; '.join(
            f'{name} {_median(ts):.4f}' for name, ts in ms.items()) +
            f' (device ms, medians of 2) [{card}]', flush=True)
    return report


def _encode_fwd_call(lib, entry: str, table, pos, lo, win, layout,
                     sub_block: int):
    """A variant's windowed forward (``entry``, the cell or window encode's
    exact forward; both take table, pos, lo, win, the layout tensors, out,
    levels, n, nsb, rows, stream) as a callable: the wrapper's allocation
    and the ctypes call."""
    import torch
    levels, _, rows, _ = table.shape
    n = pos.shape[0]
    ptrs = [t.data_ptr() for t in (table, pos, lo, win, *layout)]

    def call():
        out = torch.empty((2 * levels, n), device=pos.device)
        _checked(getattr(lib, entry)(
            *ptrs, out.data_ptr(), levels, n, n // sub_block, rows,
            torch.cuda.current_stream().cuda_stream))
        return out
    return call


def _one_level(lv: int, table, lo, win, layout) -> tuple:
    """The inputs of a forward call that encodes level ``lv`` alone."""
    return (table[lv:lv + 1].contiguous(), lo[lv:lv + 1].contiguous(),
            win[lv:lv + 1].contiguous(),
            [t[lv:lv + 1].contiguous() for t in layout])


def _sorted_uniform(rng, n: int):
    """``n`` positions uniform in [0.2, 0.8]^3 (phase 2's), morton-sorted,
    and the same unsorted, on the card."""
    import numpy as np
    import torch

    from nerficg_torch.ops.hash_window import morton_sort_keys
    dev = torch.device('cuda')
    pos = torch.from_numpy(rng.uniform(0.2, 0.8, (n, 3)).astype(
        np.float32)).to(dev)
    pos = pos[torch.sort(morton_sort_keys(pos), stable=True).indices]
    shuffled = pos[torch.from_numpy(rng.permutation(n)).to(dev)]
    return pos.contiguous(), shuffled.contiguous()


def encode_fwd(kind: str, variants: dict[str, tuple],
               rounds: int = 3) -> dict:
    """Each variant's exact windowed forward, the cell encode (#8,
    ``kind`` 'cell': phase 2's 262,144 samples on the (16, 2, 4096, 128)
    table of configs/ingp_parity.yaml, and a serving chunk's 196,608) or
    the window encode (#1, 'window': a serving chunk's 196,608 on the
    library's (16, 2, 128, 128)), each morton-sorted and unsorted: the
    windows per level and, for the window encode, the share of blocks that
    stage theirs (at FWD_WIN_ROWS, and at each ``:kFwdWinRows=N``
    variant's budget), every
    variant's output against the first variant's with ``torch.equal`` and
    against the plain version (atol 1e-5), then device time (CUDA graph of
    20 calls) in turns; the cell encode also on an occupancy-grid refresh's
    4,194,304 cells in index order; then each level alone on the sorted
    inputs. The
    window encode also times each variant over 8,192-196,608 sorted
    samples, and its stochastic forward (4 corners with saves, a training
    step's 65,536 samples), output and saved streams against the first
    variant's."""
    import numpy as np
    import torch

    from nerficg_torch.ops import hash_cell as hc
    from nerficg_torch.ops import hash_window as hw
    from nerficg_torch.ops.hashgrid import HashGridConfig

    card = _card()
    tag = f'{kind}-fwd'
    cell = kind == 'cell'
    mod = hc if cell else hw
    entry = f'nerficg_hash_{kind}_fwd'
    entries = (entry,) if cell else (entry, 'nerficg_hash_window_fwd_stoch')
    libs = {}
    report = {'card': card, 'ptxas': {}, 'inputs': {}, 'levels': {},
              'sizes': {}}
    for name, (source, overrides) in variants.items():
        libs[name], ptxas = _build_variant(name, source, entries, overrides)
        report['ptxas'][name] = ptxas
        print(f'{tag}: {name} ({source} {overrides or ""}) ptxas:\n{ptxas}',
              flush=True)
    first = next(iter(libs))
    config = HashGridConfig(num_levels=16, features_per_level=2,
                            log2_table_size=19 if cell else 14,
                            base_resolution=16, target_resolution=2048,
                            anchor_stride=8)
    rows = 4096 if cell else 128
    sub_block = hc.CELL_SUB_BLOCK * 128 if cell else hw.SUB_BLOCK * 128
    bases = hc.cell_window_bases if cell else hw.window_bases
    plain = hc.hash_cell_fwd_plain if cell else hw.hash_window_fwd_plain
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.uniform(-1, 1, (16, 2, rows, 128)).astype(
        np.float32)).cuda()
    layout = mod._layout_tensors(config, table.device)
    budgets = {} if cell else {
        name: int(overrides.get('kFwdWinRows', hw.FWD_WIN_ROWS))
        for name, (_, overrides) in variants.items()}
    sets = {}
    for n in ((262144, 196608) if cell else (196608,)):
        pos, shuffled = _sorted_uniform(rng, n)
        sets[f'{n:,} morton-sorted'] = pos
        sets[f'{n:,} unsorted'] = shuffled
    if cell:
        # An occupancy-grid refresh: every cell of two 128^3 grids in index
        # order (x slowest), at a uniform offset in its cell.
        cells = torch.arange(2 * 128 ** 3, device=table.device) % 128 ** 3
        xyz = torch.stack([cells // 128 ** 2, (cells // 128) % 128,
                           cells % 128], -1).float()
        offsets = torch.from_numpy(rng.uniform(
            0, 1, (cells.shape[0], 3)).astype(np.float32)).cuda()
        sets['4,194,304 grid cells in index order'] = (
            (xyz + offsets) / 128).clamp(max=1 - 1e-6).contiguous()
    for label, p in sets.items():
        lo, win = bases(p, config)
        want = plain(table, p, lo, win, config)
        windows = cell_window_report(win, 0 if cell else hw.FWD_WIN_ROWS)
        entry_report = {'windows': windows, 'variants': {},
                        'budget_share': {}}
        staged = '' if cell else f', share staged at {hw.FWD_WIN_ROWS} rows'
        print(f'{tag} {label}: windows per level (rows min/median/max'
              f'{staged}): ' +
              '; '.join(f'{lv}: {w["min"]}/{w["median"]:g}/{w["max"]}' +
                        ('' if cell else f' {w["resident_share"]:.3f}')
                        for lv, w in enumerate(windows['levels'])) +
              ('' if cell else
               f'; all levels {windows["resident_share"]:.3f}'), flush=True)
        for b in sorted(set(budgets.values())):
            share = float((win <= b).float().mean())
            entry_report['budget_share'][b] = share
            print(f'{tag} {label}: share staged at {b} rows {share:.3f}',
                  flush=True)
        calls = {name: _encode_fwd_call(lib, entry, table, p, lo, win,
                                        layout, sub_block)
                 for name, lib in libs.items()}
        ref = calls[first]()
        for name, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            entry_report['variants'][name] = {
                'max_abs_err': float((got - want).abs().max()),
                'close': bool(torch.allclose(got, want, rtol=0.0,
                                             atol=1e-5)),
                'equal_first': bool(torch.equal(got, ref))}
        ms = _turns(calls, rounds)
        for name, v in entry_report['variants'].items():
            v['ms'] = ms[name]
            print(f'{tag} {label}: {name}: device ms ' +
                  ', '.join(f'{t:.4f}' for t in ms[name]) +
                  f' (median {_median(ms[name]):.4f}); max_abs_err '
                  f'{v["max_abs_err"]:.3e} '
                  f'{"ok" if v["close"] else "MISMATCH"}, '
                  f'{"equal to" if v["equal_first"] else "DIFFERS from"} '
                  f'{first} [{card}]', flush=True)
        report['inputs'][label] = entry_report

    # Where the time goes by level: each level encoded alone (its table
    # plane, windows and layout), on the first sorted input set.
    p = next(iter(sets.values()))
    lo, win = bases(p, config)
    for lv in range(16):
        args = _one_level(lv, table, lo, win, layout)
        calls = {name: _encode_fwd_call(lib, entry, args[0], p, args[1],
                                        args[2], args[3], sub_block)
                 for name, lib in libs.items()}
        ref = calls[first]()
        same = all(torch.equal(call(), ref) for call in calls.values())
        ms = _turns(calls, 1)
        report['levels'][lv] = {'ms': ms, 'equal': same}
        print(f'{tag} level {lv} alone ({next(iter(sets))}, median window '
              f'{float(win[lv].float().median()):g} rows): ' + '; '.join(
                  f'{name} {_median(ts):.4f}' for name, ts in ms.items()) +
              f' (device ms, medians of 2), '
              f'{"equal" if same else "DIFFER"} [{card}]', flush=True)
    if cell:
        return report

    # Where staging pays: the sample counts of serving's last chunks and
    # of smaller calls.
    for n in (8192, 16384, 32768, 65536, 131072):
        p, _ = _sorted_uniform(rng, n)
        lo, win = bases(p, config)
        calls = {name: _encode_fwd_call(lib, entry, table, p, lo, win,
                                        layout, sub_block)
                 for name, lib in libs.items()}
        ref = calls[first]()
        same = all(torch.equal(call(), ref) for call in calls.values())
        ms = _turns(calls, 1)
        report['sizes'][n] = {'ms': ms, 'equal': same}
        print(f'{tag} {n:,} morton-sorted: ' + '; '.join(
            f'{name} {_median(ts):.4f}' for name, ts in ms.items()) +
            f' (device ms, medians of 2), {"equal" if same else "DIFFER"} '
            f'[{card}]', flush=True)

    # The stochastic forward (4 corners with saved streams) at a training
    # step's 65,536 samples: output and streams equal to the first
    # variant's, and its time.
    p, _ = _sorted_uniform(rng, 65536)
    lo, win = bases(p, config)
    n = p.shape[0]

    def stoch(lib):
        def call():
            out = torch.empty((32, n), device=p.device)
            idx = torch.empty((16, 4, n), dtype=torch.int32, device=p.device)
            w = torch.empty((16, 4, n), device=p.device)
            _checked(lib.nerficg_hash_window_fwd_stoch(
                *[t.data_ptr() for t in (table, p, lo, win, *layout)],
                out.data_ptr(), idx.data_ptr(), w.data_ptr(), 16, n,
                n // sub_block, rows, 4, 0x9E3779B9,
                torch.cuda.current_stream().cuda_stream))
            return out, idx, w
        return call
    calls = {name: stoch(lib) for name, lib in libs.items()}
    ref = calls[first]()
    same = all(all(torch.equal(a, b) for a, b in zip(call(), ref))
               for call in calls.values())
    ms = _turns(calls, rounds)
    report['stoch'] = {'ms': ms, 'equal': same}
    print(f'{tag} stochastic, 4 corners + saves, 65,536 morton-sorted: ' +
          '; '.join(f'{name} {_median(ts):.4f}' for name, ts in ms.items()) +
          f' (device ms, medians of {2 * rounds}); outputs and streams '
          f'{"equal" if same else "DIFFER"} [{card}]', flush=True)
    return report


def _window_positions(n: int, rows: int, sort: bool, rng):
    """A training step's inputs of #2 on the card, drawn from ``rng``:
    samples uniform in [0.2, 0.8]^3, morton-sorted or not, their windows on
    a (16, 2, rows, 128) table's layout (rows 128: the library's 2^14; 512:
    2^16), and a normal cotangent (32, n)."""
    import numpy as np
    import torch

    from nerficg_torch.ops import hash_window as hw
    from nerficg_torch.ops.hashgrid import HashGridConfig

    config = HashGridConfig(num_levels=16, features_per_level=2,
                            log2_table_size={128: 14, 512: 16}[rows],
                            base_resolution=16, target_resolution=2048,
                            anchor_stride=8)
    dev = torch.device('cuda')
    pos = torch.from_numpy(rng.uniform(0.2, 0.8, (n, 3)).astype(
        np.float32)).to(dev)
    if sort:
        pos = pos[torch.sort(hw.morton_sort_keys(pos), stable=True).indices]
    pos = pos.contiguous()
    lo, win = hw.window_bases(pos, config)
    g = torch.from_numpy(rng.normal(size=(32, n)).astype(np.float32)).to(dev)
    return g, pos, lo, win, config


def _window_streams(n: int, nc: int, rows: int, sort: bool, seed: int):
    """A training step's inputs of #3 on the card: a (16, 2, rows, 128)
    table, then ``_window_positions``' samples and cotangent, from one
    generator, and the stochastic forward's saved (16, nc, n) streams."""
    import numpy as np
    import torch

    from nerficg_torch.ops import hash_window as hw

    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.uniform(-1, 1, (16, 2, rows, 128)).astype(
        np.float32)).to(torch.device('cuda'))
    g, pos, lo, win, config = _window_positions(n, rows, sort, rng)
    _, idx, w = hw.hash_window_fwd_stoch(table, pos, lo, win, config, nc,
                                         0x9E3779B9, save=True)
    return g, idx, w


def _window_bwd_call(lib, g, idx, w, rows):
    """A variant's cached table gradient as the wrapper runs it: the
    allocation and the ctypes call (the same entry in the parent)."""
    import torch
    levels, nc, n = idx.shape

    def call():
        d = torch.empty((levels, 2, rows, 128), device=g.device)
        _checked(lib.nerficg_hash_window_bwd_cached(
            g.data_ptr(), idx.data_ptr(), w.data_ptr(), d.data_ptr(), levels,
            n, nc, rows, torch.cuda.current_stream().cuda_stream))
        return d
    return call


def index_add_call(g, idx, w, rows):
    """One ``index_add_`` of the precomputed products g * w into a zeroed
    (L, 2, rows, 128) plane: #3's function as one library call (the
    products are made here, outside the timed call)."""
    import torch
    levels, nc, n = idx.shape
    entries = rows * 128
    base = (torch.arange(2 * levels, device=g.device) * entries).reshape(
        levels, 2, 1, 1)
    flat = (base + idx.long()[:, None]).reshape(-1)
    prods = (g.reshape(levels, 2, 1, n) * w[:, None]).reshape(-1)

    def call():
        out = torch.zeros(levels * 2 * entries, device=g.device)
        return out.index_add_(0, flat, prods)
    return call


def _window_bwd_exact_call(lib, g, pos, lo, win, config, rows):
    """A variant's exact table gradient (#2) as the wrapper runs it: the
    allocation and the ctypes call (the same entry in the parent)."""
    import torch

    from nerficg_torch.ops import hash_window as hw
    levels, n = config.num_levels, pos.shape[0]
    layout = hw._layout_tensors(config, pos.device)

    def call():
        d = torch.empty((levels, 2, rows, 128), device=g.device)
        _checked(lib.nerficg_hash_window_bwd(
            g.data_ptr(), pos.data_ptr(), lo.data_ptr(), win.data_ptr(),
            *(t.data_ptr() for t in layout), d.data_ptr(), levels, n,
            n // 8192, rows, torch.cuda.current_stream().cuda_stream))
        return d
    return call


def exact_index_add_call(g, pos, lo, win, config, rows):
    """#2's function as one library call: ``index_add_call`` of the 8 exact
    corners (the plain version's entries and weights, made here, outside
    the timed call)."""
    import torch

    from nerficg_torch.ops import hash_window as hw
    lay = hw.window_layout(config)
    corners = [hw._exact_corners(pos, lay, lv, lo, win)
               for lv in range(config.num_levels)]
    idx = torch.stack([i.T for i, _ in corners])
    w = torch.stack([wt.T for _, wt in corners])
    return index_add_call(g, idx, w, rows)


def window_bwd(variants: dict[str, tuple], rounds: int = 3) -> dict:
    """Each variant's window table gradients. The exact one (#2), from
    positions: phase 2's 65,536 morton-sorted samples x 8 corners on the
    library's (16, 2, 128, 128) table, 262,144 samples, unsorted samples
    and a 2^16 table (512 rows, past a block's shared memory: the global
    path). The cached one (#3), from the stochastic forward's saved
    streams: 65,536 sorted x 4 corners, 262,144, 1 and 2 corners, unsorted
    and the 2^16 table. Each variant against the plain version (rtol 1e-4 /
    atol 1e-5 x max, atomics), then device time (CUDA graph of 20 calls)
    in turns with one ``index_add_`` of the precomputed products into a
    zeroed plane (``library``), and the host's ms per call. Block shapes
    are variants: ``NAME=PATH:kBwdLevelBlocks=N``."""
    import numpy as np
    import torch

    from nerficg_torch.ops import hash_window as hw

    card = _card()
    libs = {}
    report = {'card': card, 'ptxas': {}, 'inputs': {}}
    for name, (source, overrides) in variants.items():
        libs[name], ptxas = _build_variant(
            name, source, ('nerficg_hash_window_bwd',
                           'nerficg_hash_window_bwd_cached'), overrides)
        report['ptxas'][name] = ptxas
        print(f'window-bwd: {name} ({source} {overrides or ""}) ptxas:\n'
              f'{ptxas}', flush=True)

    def timed(label, entry, want, calls):
        for name, call in calls.items():
            got = call().reshape(want.shape)
            torch.cuda.synchronize()
            entry['variants'][name] = {
                'max_abs_err': float((got - want).abs().max()),
                'close': bool(torch.allclose(
                    got, want, rtol=1e-4,
                    atol=1e-5 * float(want.abs().max())))}
        ms = _turns(calls, rounds)
        for name, call in calls.items():
            v = entry['variants'][name]
            v['ms'] = ms[name]
            v['host_ms'], v['enqueue_ms'] = host_ms(call)
            print(f'window-bwd {label}: {name}: device ms ' +
                  ', '.join(f'{t:.4f}' for t in ms[name]) +
                  f' (median {_median(ms[name]):.4f}), host '
                  f'{v["host_ms"]:.4f} ms per call (enqueue '
                  f'{v["enqueue_ms"]:.4f}); max_abs_err '
                  f'{v["max_abs_err"]:.3e} '
                  f'{"ok" if v["close"] else "MISMATCH"} [{card}]',
                  flush=True)
        report['inputs'][label] = entry

    exact = [('#2 65,536 sorted, 8 corners', 65536, 128, True),
             ('#2 262,144 sorted, 8 corners', 262144, 128, True),
             ('#2 65,536 unsorted, 8 corners', 65536, 128, False),
             ('#2 2^16 table, 65,536 sorted, 8 corners', 65536, 512, True)]
    for label, n, rows, sort in exact:
        g, pos, lo, win, config = _window_positions(
            n, rows, sort, np.random.default_rng(n + rows))
        want = hw.hash_window_bwd_plain(g, pos, lo, win, config, rows)
        calls = {name: _window_bwd_exact_call(lib, g, pos, lo, win, config,
                                              rows)
                 for name, lib in libs.items()}
        calls['library'] = exact_index_add_call(g, pos, lo, win, config,
                                                rows)
        timed(label, {'kernel': 2, 'n': n, 'nc': 8, 'rows': rows,
                      'sorted': sort, 'path': hw.window_bwd_path(rows),
                      'variants': {}}, want, calls)
        del calls, want
    cached = [('#3 65,536 sorted, 4 corners', 65536, 4, 128, True),
              ('#3 262,144 sorted, 4 corners', 262144, 4, 128, True),
              ('#3 65,536 sorted, 2 corners', 65536, 2, 128, True),
              ('#3 65,536 sorted, 1 corner', 65536, 1, 128, True),
              ('#3 65,536 unsorted, 4 corners', 65536, 4, 128, False),
              ('#3 2^16 table, 65,536 sorted, 4 corners', 65536, 4, 512,
               True)]
    for label, n, nc, rows, sort in cached:
        g, idx, w = _window_streams(n, nc, rows, sort, seed=n + nc + rows)
        want = hw.hash_window_bwd_cached_plain(g, idx, w, rows)
        calls = {name: _window_bwd_call(lib, g, idx, w, rows)
                 for name, lib in libs.items()}
        calls['library'] = index_add_call(g, idx, w, rows)
        timed(label, {'kernel': 3, 'n': n, 'nc': nc, 'rows': rows,
                      'sorted': sort, 'path': hw.window_bwd_path(rows),
                      'variants': {}}, want, calls)
    return report


def _device_ops(fn) -> int:
    """The card's operations (kernels, copies, memsets) in one warm
    ``fn()``, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, 'is_user_annotation', False))


def boundary_values(scale: float, cascades: int, res: int,
                    center: float = 0.0):
    """f32 coordinates along one axis of every cascade boundary and every
    cell boundary of every cascade of a grid about ``center`` with
    half-extent ``scale`` (one cascade: the single grid over [center -
    scale, center + scale]), each with its neighbours one ulp below and
    above."""
    import numpy as np
    base = scale / 2 ** (cascades - 1)
    j = np.arange(res + 1, dtype=np.float32) / np.float32(res)
    edges = np.concatenate([np.float32(center) + (j - np.float32(0.5))
                            * np.float32(2.0) * np.float32(base * 2 ** k)
                            for k in range(cascades)]).astype(np.float32)
    return np.concatenate([edges, np.nextafter(edges, np.float32(-np.inf)),
                           np.nextafter(edges, np.float32(np.inf))])


def probe_points(n: int, scale: float, seed: int, edges=None):
    """n world points as ``march_rays`` probes them in a served frame at
    ``scale``: along rays from a ring of cameras at 2.5 scale toward the box
    (the candidate pass's (rays, probes) planes or the expanded samples'
    (blocks, 8)), as three (n // 8, 8) f32 planes on the card. With
    ``edges`` (``boundary_values``), the last len(edges) points each take
    one of them on one axis (cycling x, y, z)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    rays = n // 8
    ang = rng.uniform(0, 2 * np.pi, rays)
    origins = np.stack([2.5 * scale * np.sin(ang),
                        rng.uniform(-0.5, 0.5, rays) * scale,
                        2.5 * scale * np.cos(ang)], -1)
    target = rng.uniform(-0.6, 0.6, (rays, 3)) * scale
    d = target - origins
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = 1.5 * scale + np.sort(rng.uniform(0, 2.0 * scale, (rays, 8)), 1)
    p = (origins[:, None] + d[:, None] * t[..., None]).astype(
        np.float32).reshape(-1, 3)
    if edges is not None:
        k = np.arange(len(edges))
        p[len(p) - len(edges) + k, k % 3] = edges
    return [torch.from_numpy(np.ascontiguousarray(
        p[:, d].reshape(rays, 8))).cuda() for d in range(3)]


def probe(rounds: int = 3) -> dict:
    """The marcher's occupancy probe as ``march_rays`` calls it at SCALE
    1.0 (2 cascades of 128^3, cap 2048 blocks, a shell-shaped grid): the
    parent's composition (``_cascade_cell_coords``' PyTorch operations,
    then ``block_probe_cells``) against the world-plane kernel
    (``occupancy_probe_block_cascaded_xyz``, one launch), at the candidate
    pass's 344,064 probes (1536 rays x 32 blocks x 7) and a serving chunk's
    196,608 expanded samples; then the single-grid form (SCALE 0.5) the
    same way. Outputs held equal, device ms (CUDA graph of 20 calls) in
    turns, host ms per call, the card's operations per call; how the card
    divides a tensor by a Python float (against the product with the f32
    reciprocal and the f32 quotient); and the plain composition on the card
    against the CPU's on points at cascade and cell boundaries +-1 ulp
    (SCALE 0.7, 1.0, 1.5, 3.0)."""
    import numpy as np
    import torch

    from nerficg_torch.ops import occupancy as occ
    from nerficg_torch.ops.xbar_gather import (block_probe_cells,
                                               build_block_bitfield)

    card = _card()
    report = {'card': card, 'shapes': {}, 'card_vs_cpu': {}}
    res, cap = 128, 2048
    for scale, cascades in ((1.0, 2), (0.5, 1)):
        idx = (np.arange(res, dtype=np.float32) + 0.5) / res
        flags = []
        for c in range(cascades):
            half = scale / 2 ** (cascades - 1) * 2 ** c
            ax = (idx - 0.5) * 2.0 * half
            x, y, z = np.meshgrid(ax, ax, ax, indexing='ij')
            r = np.sqrt(x * x + y * y + z * z)
            flags.append((np.abs(r - 0.8 * scale) <= 4.0 * 2.0 * half / res
                          ).reshape(-1))
        table = build_block_bitfield(
            torch.from_numpy(np.concatenate(flags)).cuda(), res, cap,
            num_grids=cascades)
        center = torch.zeros(3, device='cuda')
        amin, amax = center - scale, center + scale
        for label, n in (('candidate pass', 1536 * 32 * 7),
                         ('serving chunk samples', 196608)):
            px, py, pz = probe_points(n, scale, seed=n)
            if cascades > 1:
                def composition():
                    c, cx, cy, cz = occ._cascade_cell_coords(
                        px, py, pz, center, scale, res, cascades)
                    return block_probe_cells(table, cx, cy, cz, c, res, cap,
                                             num_grids=cascades)

                def kernel():
                    return occ.occupancy_probe_block_cascaded_xyz(
                        table, px, py, pz, center, scale, res, cascades, cap)
            else:
                def composition():
                    return occ.occupancy_probe_block_xyz(
                        table, (px - amin[0]) / (amax[0] - amin[0]),
                        (py - amin[1]) / (amax[1] - amin[1]),
                        (pz - amin[2]) / (amax[2] - amin[2]), res, cap)

                def kernel():
                    return occ.occupancy_probe_block_aabb_xyz(
                        table, px, py, pz, amin, amax, res, cap)
            calls = {'parent composition': composition, 'kernel': kernel}
            equal = bool(torch.equal(composition(), kernel()))
            ms = _turns(calls, rounds)
            tag = f'SCALE {scale} ({cascades} cascade(s)), {label} {n}'
            entry = {'equal': equal, 'calls': {}}
            for name, call in calls.items():
                host, enqueue = host_ms(call)
                entry['calls'][name] = {'ms': ms[name], 'host_ms': host,
                                        'enqueue_ms': enqueue,
                                        'device_ops': _device_ops(call)}
                e = entry['calls'][name]
                print(f'probe {tag}: {name}: device ms ' +
                      ', '.join(f'{t:.4f}' for t in ms[name]) +
                      f' (median {_median(ms[name]):.4f}), host '
                      f'{host:.4f} ms per call (enqueue {enqueue:.4f}), '
                      f'{e["device_ops"]} device ops per call; outputs '
                      f'{"equal" if equal else "DIFFER"} [{card}]',
                      flush=True)
            report['shapes'][tag] = entry
    # How the card divides a tensor by a Python float (m / base_half in the
    # cascade): against the product with the f32 reciprocal, which the
    # kernel computes, and the f32 quotient.
    rng = np.random.default_rng(5)
    m = rng.uniform(0.0, 4.0, 1 << 20).astype(np.float32)
    for base_half in (0.35, 0.75, 1.5):
        card_q = (torch.from_numpy(m).cuda() / base_half).cpu().numpy()
        recip = m * (np.float32(1.0) / np.float32(base_half))
        quot = m / np.float32(base_half)
        report['card_vs_cpu'][f'm / {base_half}'] = {
            'points': int(m.size),
            'equal_reciprocal_product': int((card_q == recip).sum()),
            'equal_quotient': int((card_q == quot).sum())}
        print(f'probe: m / {base_half} on the card over {m.size} f32 m in '
              f'[0, 4): equal to m * f32(1 / {base_half}) at '
              f'{int((card_q == recip).sum())}, to the f32 quotient at '
              f'{int((card_q == quot).sum())} [{card}]', flush=True)
    # The plain composition on the card against the CPU's, at boundaries.
    for scale in (0.7, 1.0, 1.5, 3.0):
        cascades = occ.num_cascades(scale)
        vals = boundary_values(scale, cascades, res)
        p = rng.uniform(-1.3 * scale, 1.3 * scale, (3, 3 * len(vals))
                        ).astype(np.float32)
        for d in range(3):
            p[d, d * len(vals):(d + 1) * len(vals)] = vals
        cpu = occ._cascade_cell_coords(*map(torch.from_numpy, p),
                                       torch.zeros(3), scale, res, cascades)
        gpu = occ._cascade_cell_coords(
            *(torch.from_numpy(a).cuda() for a in p),
            torch.zeros(3, device='cuda'), scale, res, cascades)
        diff = torch.zeros(p.shape[1], dtype=torch.bool)
        for a, b in zip(cpu, gpu):
            diff |= a != b.cpu()
        where = np.flatnonzero(diff.numpy())
        report['card_vs_cpu'][scale] = {
            'points': int(p.shape[1]), 'differ': int(len(where)),
            'examples': p[:, where[:5]].T.tolist()}
        print(f'probe SCALE {scale}: the plain cascade and cells on the card '
              f'against the CPU at {p.shape[1]} boundary points: '
              f'{len(where)} differ, e.g. {p[:, where[:3]].T.tolist()} '
              f'[{card}]', flush=True)
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
                                         'xbar-bwd', 'xbar-fwd',
                                         'seg-scatter', 'cell-bwd',
                                         'cell-fwd', 'window-fwd',
                                         'window-bwd', 'probe'))
    parser.add_argument('--root', default=None,
                        help='import nerficg_torch from this checkout')
    parser.add_argument('--variant', action='append', default=[],
                        help='NAME=PATH[:CONST=VALUE,...] of a gs_tiles.cu '
                        '(gs-bwd, gs-fwd), a hash_xbar.cu (xbar-bwd, '
                        'xbar-fwd), a seg_ops.cu (seg-scatter), a '
                        'hash_cell.cu (cell-bwd, cell-fwd) or a '
                        'hash_window.cu (window-fwd, window-bwd), its '
                        'constexpr int '
                        'CONSTs set to VALUEs')
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
    if args.what == 'probe':
        _write('probe.json', probe())
        return
    variants = dict(map(_parse_variant, args.variant))
    if args.what == 'gs-bwd':
        _write('gs_bwd_ab.json', gs_bwd(variants))
    elif args.what == 'gs-fwd':
        _write('gs_fwd_ab.json', gs_fwd(variants))
    elif args.what == 'xbar-bwd':
        _write('xbar_bwd_ab.json', xbar_bwd(variants, Path(args.capture)))
    elif args.what == 'seg-scatter':
        _write('seg_scatter_ab.json', seg_scatter(variants))
    elif args.what == 'cell-bwd':
        _write('cell_bwd_ab.json', cell_bwd(variants))
    elif args.what == 'window-bwd':
        _write('window_bwd_ab.json', window_bwd(variants))
    elif args.what in ('cell-fwd', 'window-fwd'):
        kind = args.what.split('-')[0]
        _write(f'{kind}_fwd_ab.json', encode_fwd(kind, variants))
    else:
        _write('xbar_fwd_ab.json', xbar_fwd(variants, Path(args.capture)))


if __name__ == '__main__':
    main()
