#!/usr/bin/env python3
"""Drive the PyTorch port (nerficg_torch) once on one CUDA card.

Phases, each printing its own lines:
  0. environment: refuse to run without a CUDA card; print the card's name
     and power limit (nvidia-smi), the torch and CUDA versions;
  1. build the CUDA kernel library from nerficg_torch/csrc/;
  2. compare every kernel of the serving path with its plain PyTorch version
     on the card, at the shapes the main path gives it, and time both;
  3. main path: write a textured synthetic scene and an Instant-NGP
     checkpoint at full library width (random weights from a numpy seed,
     a shell-shaped occupancy grid), run the port's inference entry point
     (`python -m nerficg_torch.scripts.inference -d RUN -s test -m -b`) in
     this process, and check that every kernel launched, the renders are
     finite and the sphere is visible.
The line before the last is the JSON kernel report; the last line is the
JSON result. Any failure exits non-zero before either is printed.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Kernel -> (route, source, TPU kernel it replaces).
KERNELS = {
    'hash_window_fwd': ('cuda', 'nerficg_torch/csrc/hash_window.cu',
                        'nerficg_tpu/ops/hash_window.py:468'),
    'block_probe': ('cuda', 'nerficg_torch/csrc/block_probe.cu',
                    'nerficg_tpu/ops/xbar_gather.py:36'),
    'seg_gather': ('cuda', 'nerficg_torch/csrc/seg_ops.cu',
                   'nerficg_tpu/ops/hash_mxu.py:65'),
    'seg_scatter_add': ('cuda', 'nerficg_torch/csrc/seg_ops.cu',
                        'nerficg_tpu/ops/hash_mxu.py:144'),
}


def fail(message: str) -> None:
    print(f'FAIL: {message}', flush=True)
    sys.exit(1)


def phase0_environment():
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this script runs only on '
             'a CUDA card')
    if not (ROOT / 'nerficg_torch' / 'csrc').is_dir():
        fail(f'nerficg_torch/ is missing next to {Path(__file__).name}')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f'phase 0: python {sys.version.split()[0]}, torch '
          f'{torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.device_count()} card(s)', flush=True)
    for module in ('yaml', 'PIL'):
        try:
            __import__(module)
            print(f'phase 0: {module} imported')
        except ImportError:
            print(f'phase 0: {module} missing')
    return card


def phase1_build(card: str) -> None:
    from nerficg_torch.ops import _kernels
    path, seconds = _kernels.build_library()
    _kernels.load_library()
    print(f'phase 1: built {path.name} in {seconds:.2f} s (0 = reused) '
          f'[{card}]', flush=True)


def cuda_ms(fn, iters: int = 50) -> float:
    """Mean device time of fn() in ms over ``iters`` launches (CUDA events),
    after one warm-up call."""
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


def shell_density_grid(resolution: int, cascades: int, scale: float,
                       radius: float = 0.8, thickness_cells: float = 8.0):
    """(cascades * res^3,) float32: 1e3 on a shell of ``thickness_cells``
    cells around ``radius`` (the scene's sphere) in every cascade, 0
    elsewhere (cell order of nerficg_tpu/ops/occupancy.py
    cascade_cell_positions). With random weights the field's density is of
    order 1, so a thin shell stays nearly transparent: 8 cells give the
    sphere a mean alpha near 0.09 where 2 cells give 0.03."""
    import numpy as np
    grids = []
    idx = (np.arange(resolution, dtype=np.float32) + 0.5) / resolution
    for c in range(cascades):
        half = scale / 2 ** (cascades - 1) * 2 ** c
        axis = (idx - 0.5) * 2.0 * half
        x, y, z = np.meshgrid(axis, axis, axis, indexing='ij')
        r = np.sqrt(x * x + y * y + z * z)
        cell = 2.0 * half / resolution
        grids.append(np.where(np.abs(r - radius) <= 0.5 * thickness_cells
                              * cell, 1e3, 0.0).astype(np.float32).reshape(-1))
    return np.concatenate(grids)


def phase2_kernels(card: str) -> dict:
    """Each kernel against its plain version at the serving path's shapes
    (configs/ingp_e2e_bench.yaml: 1536-ray chunks, 196,608 samples =
    24,576 blocks of 8, 32 blocks x 7 probes per ray, 2 cascades)."""
    import numpy as np
    import torch

    from nerficg_torch.ops.hash_mxu import (seg_gather, seg_gather_plain,
                                            seg_scatter_add,
                                            seg_scatter_add_plain)
    from nerficg_torch.ops.hash_window import (hash_window_fwd,
                                               hash_window_fwd_plain,
                                               morton_sort_keys, window_bases)
    from nerficg_torch.ops.hashgrid import HashGridConfig
    from nerficg_torch.ops.xbar_gather import (block_probe_cells,
                                               block_probe_cells_plain,
                                               build_block_bitfield)

    dev = torch.device('cuda')
    rng = np.random.default_rng(1)
    report = {}

    def record(name, got, want, tol_ok, kernel_fn, plain_fn, shape):
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        ok = tol_ok(got, want)
        ms = cuda_ms(kernel_fn)
        plain_ms = cuda_ms(plain_fn)
        print(f'phase 2: {name} {shape}: max_abs_err={err:.3e} '
              f'{"ok" if ok else "MISMATCH"}; kernel {ms:.4f} ms, plain '
              f'{plain_ms:.4f} ms [{card}]', flush=True)
        if not ok:
            fail(f'{name} disagrees with its plain version')
        report[name] = {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms}

    # 1. hash_window_fwd: full-width table, one chunk of morton-sorted samples.
    config = HashGridConfig(num_levels=16, features_per_level=2,
                            log2_table_size=14, base_resolution=16,
                            target_resolution=2048, anchor_stride=8)
    n = 196608
    table = torch.from_numpy(rng.uniform(-1, 1, (16, 2, 128, 128)).astype(
        np.float32)).to(dev)
    pos = torch.from_numpy(rng.uniform(0.2, 0.8, (n, 3)).astype(
        np.float32)).to(dev)
    pos = pos[torch.sort(morton_sort_keys(pos), stable=True).indices]
    pos = pos.contiguous()
    lo, win = window_bases(pos, config)
    got = hash_window_fwd(table, pos, lo, win, config)
    want = hash_window_fwd_plain(table, pos, lo, win, config)
    record('hash_window_fwd', got, want,
           lambda a, b: bool(torch.allclose(a, b, rtol=0.0, atol=1e-5)),
           lambda: hash_window_fwd(table, pos, lo, win, config),
           lambda: hash_window_fwd_plain(table, pos, lo, win, config),
           f'table (16,2,128,128) x {n} samples')

    # 2. block_probe: 2 cascades of 128^3 with a shell, cap 2048 blocks.
    res, cascades, cap = 128, 2, 2048
    flags = torch.from_numpy(
        shell_density_grid(res, cascades, 1.0) > 0).to(dev)
    bits = build_block_bitfield(flags, res, cap, num_grids=cascades)
    m = 1536 * 32 * 7
    occ_cells = np.flatnonzero(flags.cpu().numpy())
    cells = np.concatenate([rng.choice(occ_cells, m // 2),
                            rng.integers(0, cascades * res ** 3, m - m // 2)])
    cells = torch.from_numpy(cells).to(dev)
    g = (cells // res ** 3).to(torch.int32)
    local = cells % res ** 3
    cx = (local // (res * res)).to(torch.int32)
    cy = ((local // res) % res).to(torch.int32)
    cz = (local % res).to(torch.int32)
    args = (bits, cx, cy, cz, g, res, cap, cascades)
    record('block_probe', block_probe_cells(*args),
           block_probe_cells_plain(*args),
           lambda a, b: bool(torch.equal(a, b)),
           lambda: block_probe_cells(*args),
           lambda: block_probe_cells_plain(*args),
           f'table {tuple(bits.shape)} x {m} probes')

    # 3./4. segment gather / scatter-add over one chunk's 24,576 blocks.
    nb, rays, rows = 24576, 1536, (1536 + 1 + 127) // 128
    ids = np.sort(rng.integers(0, rays + 1, nb)).astype(np.int32)
    idx = torch.from_numpy(ids[None]).to(dev)
    seg_table = torch.from_numpy(rng.normal(size=(1, 1, rows, 128)).astype(
        np.float32)).to(dev)
    record('seg_gather', seg_gather(idx, seg_table),
           seg_gather_plain(idx, seg_table),
           lambda a, b: bool(torch.equal(a, b)),
           lambda: seg_gather(idx, seg_table),
           lambda: seg_gather_plain(idx, seg_table),
           f'(1,1,{rows},128) x {nb}')
    vals = torch.from_numpy(rng.uniform(0, 1, (1, 5, nb)).astype(
        np.float32)).to(dev)
    record('seg_scatter_add', seg_scatter_add(idx, vals, rows),
           seg_scatter_add_plain(idx, vals, rows),
           lambda a, b: bool(torch.allclose(a, b, rtol=1e-5, atol=1e-6)),
           lambda: seg_scatter_add(idx, vals, rows),
           lambda: seg_scatter_add_plain(idx, vals, rows),
           f'(1,5,{nb}) -> (1,5,{rows},128)')
    return report


def make_run_dir(run_dir: Path, image_size: int, n_test: int,
                 device: str, seed: int = 0) -> dict:
    """A scene + training_config.yaml + checkpoints/final.ckpt, the layout
    the inference entry point reads. The model is configs/ingp_e2e_bench.yaml
    at full library width with random weights from a numpy seed (table
    U(-1, 1), He-uniform MLPs) and a shell-shaped density grid around the
    scene's sphere, so the marcher and every kernel do real work."""
    import numpy as np
    import torch

    from nerficg_torch.core.config import load_config, save_config
    from nerficg_torch.data.synthetic import make_textured_scene
    from nerficg_torch.methods.instant_ngp.model import InstantNGPModel

    scene = make_textured_scene(run_dir / 'scene', image_size=image_size,
                                n_train=4, n_test=n_test)
    config = load_config(ROOT / 'configs' / 'ingp_e2e_bench.yaml')
    config.DATASET.PATH = str(scene)
    save_config(config, run_dir / 'training_config.yaml')
    model = InstantNGPModel(config, device=device).build()
    rng = np.random.default_rng(seed)
    tree = model.params_tree()

    def he_uniform(w):
        bound = np.sqrt(6.0 / w.shape[0])
        return rng.uniform(-bound, bound, w.shape).astype(np.float32)

    model.load_params_tree({
        'hash_table': rng.uniform(-1, 1, tree['hash_table'].shape).astype(
            np.float32),
        'density_mlp': [he_uniform(w) for w in tree['density_mlp']],
        'color_mlp': [he_uniform(w) for w in tree['color_mlp']]})
    grid = shell_density_grid(int(model.GRID_RESOLUTION), model.cascades,
                              float(model.SCALE))
    model.buffers['density_grid'] = torch.as_tensor(grid, device=model.device)
    model.save(run_dir / 'checkpoints' / 'final.ckpt')
    return {'cascades': model.cascades, 'levels': int(model.NUM_LEVELS),
            'log2_table': int(model.LOG2_HASHMAP_SIZE)}


def load_renderer(run_dir: Path, device: str):
    """(renderer, test views) of a run dir through the port's registry."""
    from nerficg_torch.core.registry import Datasets, Methods
    from nerficg_torch.core.setup import setup
    ctx = setup(run_dir / 'training_config.yaml', device=device)
    dataset = Datasets.get_dataset(ctx.config)
    model = Methods.get_model(ctx.config, device=ctx.device,
                              checkpoint=str(run_dir / 'checkpoints' /
                                             'final.ckpt'))
    return Methods.get_renderer(ctx.config, model), dataset.subsets['test']


def render_views(run_dir: Path, device: str) -> list[dict]:
    """Render every test view of a run dir on ``device``."""
    renderer, views = load_renderer(run_dir, device)
    return [{k: v.float().cpu() for k, v in renderer.render_image(view).items()}
            for view in views]


def profile_frame(run_dir: Path, card: str) -> None:
    """torch.profiler over one warm frame: wall time, the card's busy time
    (sum of kernel and memcpy/memset time), and the largest device-time
    entries by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    renderer, views = load_renderer(run_dir, 'cuda')
    renderer.render_image(views[0], benchmark=True)            # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        renderer.render_image(views[0], benchmark=True)
        wall_ms = (time.perf_counter() - start) * 1e3
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    if busy_ms <= 0.0:
        print(f'phase 3: profile: frame {wall_ms:.1f} ms wall; device time '
              f'not measured (the profiler recorded no kernels) [{card}]')
        return
    by_name: dict[str, list] = {}
    for e in events:
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += e.time_range.elapsed_us() / 1e3
        entry[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print(f'phase 3: profile of one frame: wall {wall_ms:.1f} ms, device busy '
          f'{busy_ms:.1f} ms ({100 * (1 - busy_ms / wall_ms):.1f}% idle), '
          f'{len(events)} device ops [{card}]')
    for name, (ms, count) in top:
        print(f'phase 3:   {ms:9.3f} ms {count:6d}x  {name[:90]}')


def phase3_main_path(card: str, image_size: int = 400,
                     repeats: int = 3) -> dict:
    """The port's inference entry point on the e2e config; returns the
    kernels' launch counts from that run."""
    import numpy as np
    import torch

    from nerficg_torch.ops.hash_mxu import seg_gather, seg_scatter_add
    from nerficg_torch.ops.hash_window import hash_window_fwd
    from nerficg_torch.ops.xbar_gather import block_probe_cells
    from nerficg_torch.scripts import inference

    wrappers = {'hash_window_fwd': hash_window_fwd,
                'block_probe': block_probe_cells, 'seg_gather': seg_gather,
                'seg_scatter_add': seg_scatter_add}
    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as tmp:
        run_dir = Path(tmp) / 'run'
        start = time.perf_counter()
        info = make_run_dir(run_dir, image_size, n_test=4, device='cuda')
        print(f'phase 3: {image_size}x{image_size} scene (4 test views) and '
              f'checkpoint ({info["levels"]} levels x 2^{info["log2_table"]},'
              f' {info["cascades"]} cascades) written in '
              f'{time.perf_counter() - start:.1f} s', flush=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers.values():
            fn.launches = 0
        start = time.perf_counter()
        result = inference.main(['-d', str(run_dir), '-s', 'test', '-m',
                                 '-b', '--repeats', str(repeats)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches = {name: fn.launches for name, fn in wrappers.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        metrics = result['metrics']['test']
        print(f'phase 3: inference -s test -m -b --repeats {repeats}: '
              f'{result["fps"]:.3f} FPS at {image_size}x{image_size}, '
              f'whole run {wall:.1f} s [{card}]')
        print('phase 3: test metrics (random weights, so only finiteness '
              'matters): ' + ', '.join(f'{k}={v:.4f}'
                                       for k, v in metrics.items()) +
              f' [{card}]')
        print(f'phase 3: peak torch.cuda.max_memory_allocated '
              f'{peak:.1f} MiB [{card}]')
        print(f'phase 3: kernel launches in that run: {launches}', flush=True)
        missing = [k for k, v in launches.items() if v <= 0]
        if missing:
            fail(f'kernels never launched on the main path: {missing}')
        if not all(np.isfinite(v) for v in (metrics['PSNR'], metrics['SSIM'],
                                              result['fps'])):
            fail(f'non-finite metrics or FPS: {metrics}, {result["fps"]}')
        if not (run_dir / 'performance_0.txt').is_file():
            fail('inference -b wrote no performance_<iters>.txt')

        outs = render_views(run_dir, 'cuda')
        for out in outs:
            if out['rgb'].shape != (image_size, image_size, 3) or not all(
                    bool(torch.isfinite(v).all()) for v in out.values()):
                fail('render output has the wrong shape or non-finite values')
        mean_alpha = float(np.mean([o['alpha'].mean() for o in outs]))
        print(f'phase 3: test views finite, mean alpha {mean_alpha:.4f}')
        if mean_alpha <= 0.05:
            fail(f'mean alpha {mean_alpha:.4f} <= 0.05: the sphere is missing')
        profile_frame(run_dir, card)

    # The whole path on the card against the port's plain versions on the
    # CPU, on a small scene at the same width.
    with tempfile.TemporaryDirectory(prefix='chip_smoke_ref_') as tmp:
        run_dir = Path(tmp) / 'run'
        make_run_dir(run_dir, 40, n_test=1, device='cpu')
        gpu = render_views(run_dir, 'cuda')[0]
        cpu = render_views(run_dir, 'cpu')[0]
        for key in ('rgb', 'alpha'):
            mse = float(((gpu[key] - cpu[key]) ** 2).mean())
            db = -10.0 * np.log10(max(mse, 1e-20))
            print(f'phase 3: 40x40 {key}, CUDA kernels vs CPU plain '
                  f'versions: PSNR {db:.1f} dB (limit 45)')
            if db < 45.0:
                fail(f'card and CPU renders disagree on {key}: {db:.1f} dB')
    return launches


def main() -> None:
    import torch
    sys.path.insert(0, str(ROOT))
    card = phase0_environment()
    phase1_build(card)
    report = phase2_kernels(card)
    launches = phase3_main_path(card)
    kernels = [{'name': name, 'route': route, 'source': source,
                'replaces': replaces, 'launches': launches[name],
                **report[name]}
               for name, (route, source, replaces) in KERNELS.items()]
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
