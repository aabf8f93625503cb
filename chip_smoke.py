#!/usr/bin/env python3
"""Drive the PyTorch port (nerficg_torch) once on one CUDA card.

Phases, each printing its own lines:
  0. environment: refuse to run without a CUDA card; print the card's name
     and power limit (nvidia-smi), the torch and CUDA versions;
  1. build the CUDA kernel library from nerficg_torch/csrc/, and beside it
     the exact window encode (#1) with a shared-memory budget of 0 rows,
     every block on its gather path;
  2. compare every kernel of the serving and training paths with its plain
     PyTorch version on the card, at the shapes its path gives it, and time
     both: the kernel (and the library call) on the card's own clock, a CUDA
     graph of 50 calls, and on the host's, 50 calls ending in a synchronize;
     the 3DGS stream forward (#15) and backward on the 1080p frame and on a
     400x400 one; the 3DGS frontend pair and the entry gather pair at the
     Mip-NeRF 360 cell's 3,112,960 Gaussians, the gather beside the
     parent's composition (stack, expand, gather, pad; autograd's
     index_put_ backward); the crossbar forward (#10) at 65,536, a
     serving chunk's 196,608, D-NeRF's 262,144 and the occupancy grid's
     warm-up 4,194,304 samples, each line naming its path; the
     crossbar backward (#11, #12 and both from one call) at the Instant-NGP
     step's 65,536 and D-NeRF's 262,144 samples on the level-resident path,
     and on a 2^16-entry table, past a block's shared memory, on the gather
     path; the segment scatter-add (#7) on the serving chunk's sorted ray
     ids, and on unsorted ids with some negative or past the end and
     signed values, on its fused path, and on a training step's call, on
     its atomic path; the segment gather (#6) also on ids in
     [-2 size, 2 size), from the end and clamped; the exact window
     encode (#1) with the share of blocks that stage their window in
     shared memory, held bit for bit to its 0-row build; the cell encode
     (#8) at the parity step's 262,144 samples and a serving chunk's
     196,608, each level's windows printed; the cell table gradient (#9)
     as the wrapper runs it
     (each level's windows and the share of blocks that keep theirs in
     shared memory printed) and with level 12 forced onto the
     global-atomic path; the exact window table gradient (#2) on its
     level-resident path at 65,536 and 262,144 samples and on a 2^16
     table's global path, and the cached one (#3) on its level-resident
     path and the 2^16 table's global path, each beside one index_add_ of
     the precomputed products; the marcher's probe from
     world planes (block_probe_xyz, one launch) cascaded and over one
     grid, on points along rays and on every cascade and cell boundary
     +-1 ulp, bit-exact, beside the parent's composition of PyTorch
     operations and block_probe_cells; the flat table gather
     (xbar_gather, #4's generic entry) at the dense probe's 344,064 ids
     into 2 cascades of 128^3 bits, bit-exact (also on the table's f32
     view), beside torch.take, and the dense cascaded probe on the card
     against the CPU at every cascade and cell boundary +-1 ulp;
  3. serving path: write a textured synthetic scene and an Instant-NGP
     checkpoint at full library width (random weights from a numpy seed,
     a shell-shaped occupancy grid), run the port's inference entry point
     (`python -m nerficg_torch.scripts.inference -d RUN -s test -m -b`) in
     this process, and check that every kernel launched, the renders are
     finite and the sphere is visible;
  4. one training step with exact corners at a small width, on the card
     against the CPU plain versions (loss, gradients): the trainer's own
     code launches the exact backward kernel;
  5. training path: train configs/ingp_e2e_bench.yaml at full library width
     on a 400x400 textured scene through the port's training entry point
     (`python -m nerficg_torch.scripts.train -c ...`) in this process for
     200 iterations (the config's 2000, cut for the time limit), render and
     score the test set, and check that the training kernels launched, the
     loss fell and the test PSNR rose by at least 5 dB over the untrained
     model's; then profile one warm training step;
 5x. the same config and scene trained the same way with exact corners
     (MODEL.STOCHASTIC_CORNERS=0, the JAX model's documented exact mode):
     the exact forward (#1) and the exact table gradient (#2) launched
     once per step, the same checks, no serving; the profile of one warm
     step also gives #2's share of its busy time;
  6. the cell encode at the reference's size: configs/ingp_parity.yaml
     (16 levels x 2^19 entries, ENCODING_BACKEND cell, 262,144 samples per
     step) trained the same way for 200 iterations (its 30,000 cut; its
     scene, which the repository does not hold, replaced by the textured
     one; MODEL.SCALE=1.0 so the box holds that scene; and
     RENDERER.MAX_SAMPLES=256, a quarter of the config's occupancy
     threshold, which as published lies above the untrained density so
     that nothing trains from random weights), then served
     from the run directory through the inference entry point
     (`python -m nerficg_torch.scripts.inference -d RUN -s test -m`; the
     FPS pass `-b` left out since phase 20 came: phase 3 times serving);
  7. the crossbar encode: configs/ingp_e2e_bench.yaml with
     MODEL.ENCODING_BACKEND=xbar (2^14 entries, 4 stochastic corners in
     training), trained for 200 iterations and served the same way;
  8. 3D Gaussian Splatting serving at full width: a checkpoint of bench.py's
     100k-Gaussian model (numpy seed 0, SH degree 4 with all four bands
     active) served through the inference entry point on the textured
     scene, then bench.py's 1080p protocol through `render_image` (8 orbit
     poses, 64 frames after a warm-up), a profile of one frame and the card
     against the CPU on a small frame;
  9. 3DGS training: nerficg_torch/configs/gaussian_splatting.yaml (the
     library's defaults, 100k random points in the scene's box) through the
     training entry point for 3500 of its 30,000 iterations (densification
     every 100 from 600, the SH increases at 1000-3000, the first opacity
     reset at 3000), test PSNR against the untrained model's, a profile of
     one step, then served;
 10. one 3DGS training step at a small width, card against CPU;
 11. D-NeRF: nerficg_torch/configs/dnerf.yaml (16 levels x 2^14 on the
     crossbar, exact corners, a 48 -> 128 x 3 -> 3 deformation MLP, 262,144
     samples per step) on a 400x400 make_dynamic_textured_scene through the
     training entry point for 300 of its 30,000 iterations (#11 and #12
     from one fused call per iteration, loss falls, the deformation
     trains, test PSNR at least 5 dB above the untrained model's), a
     profile of one step, served through the
     inference entry point, and Instant-NGP with the same config on the same
     scene as the static control (printed with its launches, not checked);
 12. one D-NeRF training step at a small width, card against CPU;
 13. the op API's kernels without a caller among the methods, as a user
     calls them: composite_tiles (forward and, through autograd, backward)
     on the slot windows of bench.py's 1080p frame, held to the stream
     compositor's image; xbar_permute of a 262,144 x 4 sample stream,
     held to permute_block_channels; and the crossbar's position gradient
     alone (#12, through a frozen table's hash_encode_xbar_posgrad) at
     D-NeRF's width and 262,144 samples, held to its plain version; and
     the probe of unit coordinates (occupancy_probe_block_xyz, through
     block_probe_cells) held to its plain version.
 14. vanilla NeRF: nerficg_torch/configs/nerf.yaml at the library's width
     (8 x 256 coarse and fine blocks, 256 samples per ray, 1024 rays per
     step) on the 400x400 textured scene through the training entry point
     for 150 of its 500,000 iterations (loss falls, test PSNR at least 5
     dB above the untrained model's), a profile of one step with the
     GEMMs' share, served through the inference entry point, and the
     trained model's 32x32 render on the card against the CPU (>= 45 dB);
 15. the dense probe: configs/ingp_e2e_bench.yaml with
     RENDERER.PROBE_MODE=dense trained 200 iterations and served as phase
     6 is: xbar_gather launched, block_probe_xyz and block_probe_cells
     never.
 16. the COLMAP capture path of 3DGS: phases 5-9's scene written as a
     Mip-NeRF 360 capture (images_4 of 400x300, a 1600x1200 PINHOLE model,
     100,000 SfM points on the sphere and 2% outliers), then the port's
     create_config -m GaussianSplatting -d MipNeRF360, train (0 iterations
     for the SfM-initialised baseline, then 1000 of 30,000: five
     densifications), convert_to_ply and inference -s test ellipse_path
     -m -b: #15 and #16 once per step, the packed #15 once per served and
     trajectory frame, the loss falls, test PSNR at least 3 dB above the
     baseline, the PLY equal to the checkpoint bit for bit, 120 finite
     trajectory frames.
 17. the interactive viewer, each run as a user starts it
     (`python -m nerficg_torch.scripts.gui`) in a subprocess of its own,
     driven over HTTP on a free port at the viewer's 800x800: phase 16's
     3DGS run (5 poses) and phase 5's Instant-NGP run (1 pose) viewed
     with `-d RUN_DIR`, each pose posted to /camera until /frame.jpg
     shows it (held to this process's render of the pose, both JPEG at
     quality 90, >= 40 dB), /status's FPS, /terminate; the hand-off's
     host cost apart (push_frame, pop_frame, _encode_jpeg of an 800x800
     float32 frame); and `--train` on the GS config for 200 iterations
     with TRAINING.TIMING.PROFILE over 5 of them, /status from training
     to idle, the post-training frame held to the final checkpoint's
     render, /terminate, final.ckpt, #15 and #16 in the trace, then the
     same run in this process without the viewer for the GUI's cost per
     step. Any traceback `catch` logged in a viewer process, a missed
     deadline or a non-zero exit fails the phase.
 18. the data layer: Instant-NGP with configs/ingp_e2e_bench.yaml's MODEL,
     RENDERER and TRAINING (16 x 2^14 window encode, 4 stochastic corners)
     through create_config, train (0 iterations for the carved untrained
     baseline, then 300) and inference -s test -m -b on (a) phases 5-9's
     scene as a Colmap capture whose views alternate between a 400x300
     PINHOLE camera and a 320x240 one (0.8 x its intrinsics, the images
     resized), DATASET.NORMALIZE_PCA=False, and (b) 30 Ricoh360 panoramas
     of 256x128 of the scene's sphere from its ring (4 test views), with
     a fixed background: the ray pool on the card against the CPU's
     (origins and directions to 1e-6, the rest exactly) and its path
     (grouped over 2 cameras in (a), shared in (b)), the stochastic
     forward and cached backward once per step (the forward also once per
     grid refresh), the marcher's kernels in training and serving, the
     loss falling, test PSNR 3 dB above the untrained model's trained and
     served, finite served renders; load seconds, step ms, FPS and peak
     memory of each run.
 19. the offline tools and the metric layer, after phase 13: the doctor
     (`nerficg_torch.scripts.install.main`, exit 0); LPIPS from a
     weights npz of random VGG16 weights (`optim/lpips.py`,
     init_random_weights(0)), masked SSIM and masked PSNR of five
     400x400 pairs (one mask empty, one full) on the card against the CPU
     (1e-4 relative), and the card's LPIPS ms a pair; with
     NERFICG_LPIPS_WEIGHTS at that npz, the dataset sweep
     (`nerficg_torch.scripts.benchmark_sweep -m InstantNGP -d NeRF`) over
     two 200x200 textured scenes (2 test views each) with the e2e config's
     MODEL, RENDERER and TRAINING at 150 iterations, each scene a child
     process (a finite LPIPS= in each metrics_8bit.txt, test PSNR above
     the untrained model's, a summary.txt row each), sequential_train
     over the first scene's config, and generate_tables -m masks over the
     runs' test renders laid out as root/scene/InstantNGP beside gt/ and
     masks/ (the views' alpha), every value recomputed on the CPU (1e-4
     relative). Its kernels run in the children and are not counted:
     phase 18 counts the same config's.
 20. the last two modules, after phase 17 on phase 5's scene: (a) the
     native image decoder built from nerficg_torch/native/image_io.cpp
     (where it does not build, the phase prints why and the port decodes
     with PIL, as the JAX package would): known uint8/uint16 arrays
     written as 8- and 16-bit RGB, RGBA, gray and gray + alpha PNGs, a
     2-bit gray PNG and palette PNGs with and without tRNS decode to
     exactly those arrays, RGB and gray JPEGs to PIL's decode / 255 within
     one ulp; load_images_parallel of 100 800x800 RGBA PNGs on the native
     thread pool against PIL's thread pool, in turns (host seconds);
     (b) configs/ingp_e2e_bench.yaml trained 200
     iterations (phase 5's) over two ranks of one gloo group on the one
     card, started as a user starts them (`python -m
     torch.distributed.run --standalone --nproc_per_node 2`, each rank
     the training entry point through `chip_smoke.dp_rank`, which counts
     its launches): rank 0 alone wrote one run directory, final.ckpt
     loads, the test set rendered over both ranks gave every rank rank
     0's metrics, every rank launched #1 stochastic, #3, the probe from world
     planes, #6 and #7 and ends with parameters and grid bit-equal to
     rank 0's, test PSNR within DP_PSNR_BAND_DB of phase 5's; each rank's
     ms per step and the all-reduce ms of its gradient buffer; then one
     two-shard step with exact corners (#1 exact and #2 on each rank)
     against the same step in this process, both shards in turn (loss
     1e-5, gradients and parameters after Adam 2e-2 relative Frobenius);
     (c) NCCL at world size 1 on cuda:0, an all-reduce of (b)'s gradient
     buffer's size.
Phase 5x takes phase 5's untrained test PSNR (the same weights, grid and
test render) instead of an untrained run of its own.
Every main path of phases 3-7, 11, 18 and 20 must probe through
block_probe_xyz alone, never through block_probe_cells or xbar_gather;
phase 15 through xbar_gather alone.
Every kernel's launch count is set to 0 just before the run that drives it
and read just after (phase 17: in each viewer process, from its start to
its end); the sample counts of #1's (exact), #8's and #10's
launches in phases 3-7, 11, 15 and 18 are printed at the end (min, median,
max per run), and after phase 11 the largest segment scatter-add of phases
3-11, 15 and 18 with the path its plan took.
Each kernel's line
reports its time against the least time the card could take for the same
work (`bound_ms`: each input read once and each output written once at
3.35 TB/s, or its f32 operations at 67 TFLOP/s with each expf at the
special-function units' 4.18 T/s, whichever is larger; an encode reads
only the table entries its samples reach, a compositor counts only the
(entry, pixel) pairs whose alpha passes 1/255) and, where one PyTorch
call computes the same function, that call's time
(`library_ms`; the port never calls it). The line before the last is the
JSON kernel report; the last line is the JSON result. Any failure exits
non-zero before either is printed.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import collections
import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# Kernel -> (route, source, TPU kernel it replaces).
KERNELS = {
    'hash_window_fwd': ('cuda', 'nerficg_torch/csrc/hash_window.cu',
                        'nerficg_tpu/ops/hash_window.py:468'),
    'hash_window_fwd_stoch': ('cuda', 'nerficg_torch/csrc/hash_window.cu',
                              'nerficg_tpu/ops/hash_window.py:468'),
    'hash_window_bwd': ('cuda', 'nerficg_torch/csrc/hash_window.cu',
                        'nerficg_tpu/ops/hash_window.py:526'),
    'hash_window_bwd_cached': ('cuda', 'nerficg_torch/csrc/hash_window.cu',
                               'nerficg_tpu/ops/hash_window.py:630'),
    'block_probe': ('cuda', 'nerficg_torch/csrc/block_probe.cu',
                    'nerficg_tpu/ops/xbar_gather.py:36'),
    'block_probe_xyz': ('cuda', 'nerficg_torch/csrc/block_probe.cu',
                        'nerficg_tpu/ops/xbar_gather.py:36'),
    'seg_gather': ('cuda', 'nerficg_torch/csrc/seg_ops.cu',
                   'nerficg_tpu/ops/hash_mxu.py:65'),
    'seg_scatter_add': ('cuda', 'nerficg_torch/csrc/seg_ops.cu',
                        'nerficg_tpu/ops/hash_mxu.py:144'),
    'hash_cell_fwd': ('cuda', 'nerficg_torch/csrc/hash_cell.cu',
                      'nerficg_tpu/ops/hash_cell.py:380'),
    'hash_cell_bwd': ('cuda', 'nerficg_torch/csrc/hash_cell.cu',
                      'nerficg_tpu/ops/hash_cell.py:441'),
    'hash_xbar_fwd': ('cuda', 'nerficg_torch/csrc/hash_xbar.cu',
                      'nerficg_tpu/ops/hash_xbar.py:303'),
    'hash_xbar_bwd': ('cuda', 'nerficg_torch/csrc/hash_xbar.cu',
                      'nerficg_tpu/ops/hash_xbar.py:394'),
    'gs_composite_fwd': ('cuda', 'nerficg_torch/csrc/gs_tiles.cu',
                         'nerficg_tpu/ops/gs_tiles_kernel.py:414'),
    'gs_composite_fwd_packed': ('cuda', 'nerficg_torch/csrc/gs_tiles.cu',
                                'nerficg_tpu/ops/gs_tiles_kernel.py:414'),
    'gs_composite_bwd': ('cuda', 'nerficg_torch/csrc/gs_tiles.cu',
                         'nerficg_tpu/ops/gs_tiles_kernel.py:481'),
    'hash_xbar_bwd_pos': ('cuda', 'nerficg_torch/csrc/hash_xbar.cu',
                          'nerficg_tpu/ops/hash_xbar.py:537'),
    'hash_xbar_bwd_fused': ('cuda', 'nerficg_torch/csrc/hash_xbar.cu',
                            'nerficg_tpu/ops/hash_xbar.py:394; '
                            'nerficg_tpu/ops/hash_xbar.py:537'),
    'gs_tiles_fwd': ('cuda', 'nerficg_torch/csrc/gs_tiles.cu',
                     'nerficg_tpu/ops/gs_tiles_kernel.py:164'),
    'gs_tiles_bwd': ('cuda', 'nerficg_torch/csrc/gs_tiles.cu',
                     'nerficg_tpu/ops/gs_tiles_kernel.py:200'),
    'xbar_permute': ('cuda', 'nerficg_torch/csrc/block_probe.cu',
                     'nerficg_tpu/ops/xbar_gather.py:88'),
    'xbar_gather': ('cuda', 'nerficg_torch/csrc/block_probe.cu',
                    'nerficg_tpu/ops/xbar_gather.py:36'),
    # No TPU kernel: the JAX frontend is jnp code that XLA fuses.
    'gs_frontend_fwd': ('cuda', 'nerficg_torch/csrc/gs_frontend.cu', 'none'),
    'gs_frontend_bwd': ('cuda', 'nerficg_torch/csrc/gs_frontend.cu', 'none'),
    # No TPU kernel: the JAX package gathers the stream with XLA ops.
    'gs_stream_gather': ('cuda', 'nerficg_torch/csrc/gs_gather.cu', 'none'),
    'gs_stream_gather_bwd': ('cuda', 'nerficg_torch/csrc/gs_gather.cu',
                             'none'),
}

# Published H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s and float32
# operations/s outside the tensor cores; and the special-function units'
# rate (ex2 of expf): 16 per clock per SM (CUDA C++ Programming Guide,
# throughput table, compute capability 9.0) x 132 SMs x 1.98 GHz boost.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SFU_OPS_PER_S = 16 * 132 * 1.98e9


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


# The exact window encode (#1) with every block on its gather path: the
# source built alone with a shared-memory budget (kFwdWinRows) of 0 rows,
# so that phase 2 holds the staged path to the gather bit for bit.
WINDOW_FWD_GLOBAL = ('window_fwd_global', {'kFwdWinRows': 0})


def phase1_build(card: str):
    """Build the kernel library and, beside it, #1's gather-only build;
    returns that build."""
    from concurrent.futures import ThreadPoolExecutor

    from nerficg_torch.ops import _kernels
    name, overrides = WINDOW_FWD_GLOBAL
    start = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        variant = pool.submit(
            _kernels.build_variant, name,
            ROOT / 'nerficg_torch' / 'csrc' / 'hash_window.cu',
            ('nerficg_hash_window_fwd',), overrides)
        path, seconds = _kernels.build_library()
        _kernels.load_library()
        global_lib = variant.result()[0]
    print(f'phase 1: built {path.name} in {seconds:.2f} s (0 = reused), and '
          f'#1 with {overrides} beside it, all in '
          f'{time.perf_counter() - start:.2f} s [{card}]', flush=True)
    return global_lib


def bound(nbytes: float, ops: float, sfu: float = 0.0) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): ``nbytes`` moved at
    the HBM rate, or ``ops`` f32 operations at the peak rate and ``sfu``
    special-function operations at theirs, two pipes that overlap."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(ops / F32_OPS_PER_S, sfu / SFU_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else \
        'operations'


def nbytes(*tensors) -> int:
    """Bytes of the given tensors (inputs read once, outputs written once)."""
    return sum(t.numel() * t.element_size() for t in tensors)


def entry_bytes(per_level) -> int:
    """Bytes of the table entries an encode reads in this run: per level,
    its distinct flat indices (one tensor per level) times 2 f32 features.
    The entries no sample reaches are not counted."""
    import torch
    return sum(int(torch.unique(idx).numel()) for idx in per_level) * 2 * 4


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


def phase2_kernels(card: str, window_global_lib) -> dict:
    """Each kernel against its plain version at its path's shapes
    (configs/ingp_e2e_bench.yaml; serving: 1536-ray chunks, 196,608 samples =
    24,576 blocks of 8, 32 blocks x 7 probes per ray, 2 cascades; training:
    65,536 samples per step; configs/ingp_parity.yaml: 262,144 samples per
    step on the 2^19 cell table); #1 also against its gather-only build
    (``window_global_lib``), bit for bit."""
    import numpy as np
    import torch

    from nerficg_torch.ops import hash_window
    from nerficg_torch.ops.hash_cell import (BWD_WIN_ROWS, _cell_corners,
                                             cell_bwd_paths, cell_layout,
                                             cell_window_bases,
                                             hash_cell_bwd,
                                             hash_cell_bwd_plain,
                                             hash_cell_fwd,
                                             hash_cell_fwd_plain)
    from nerficg_torch.ops.hash_mxu import (seg_gather, seg_gather_plain,
                                            seg_scatter_add,
                                            seg_scatter_add_plain,
                                            seg_scatter_plan)
    from nerficg_torch.ops.hash_window import (
        _exact_corners, hash_window_bwd, hash_window_bwd_cached,
        hash_window_bwd_cached_plain, hash_window_bwd_plain, hash_window_fwd,
        hash_window_fwd_plain, hash_window_fwd_stoch,
        hash_window_fwd_stoch_plain, morton_sort_keys, window_bases,
        window_bwd_path, window_fwd_paths, window_layout)
    from nerficg_torch.ops.hash_xbar import (hash_xbar_bwd,
                                             hash_xbar_bwd_fused,
                                             hash_xbar_bwd_plain,
                                             hash_xbar_bwd_pos,
                                             hash_xbar_bwd_pos_plain,
                                             hash_xbar_fwd,
                                             hash_xbar_fwd_plain,
                                             xbar_bwd_plan, xbar_fwd_plan)
    from nerficg_torch.ops.hashgrid import HashGridConfig
    from nerficg_torch.ops.occupancy import (
        _cascade_cell_coords, downsample_occupancy_cascaded,
        occupancy_probe_block_aabb_xyz, occupancy_probe_block_aabb_xyz_plain,
        occupancy_probe_block_cascaded_xyz,
        occupancy_probe_block_cascaded_xyz_plain,
        occupancy_probe_cascaded_xyz)
    from nerficg_torch.ops.xbar_gather import (block_probe_cells,
                                               block_probe_cells_plain,
                                               build_block_bitfield,
                                               xbar_gather,
                                               xbar_gather_plain,
                                               xbar_permute,
                                               xbar_permute_plain)
    from nerficg_torch.scripts.kernel_timing import (boundary_values,
                                                     cell_window_report,
                                                     device_ms, events_ms,
                                                     exact_index_add_call,
                                                     host_ms, index_add_call,
                                                     probe_points)

    dev = torch.device('cuda')
    rng = np.random.default_rng(1)
    report = {}

    def record(name, got, want, tol_ok, kernel_fn, plain_fn, shape, moved,
               ops, library_fn=None, sfu=0.0, plain_iters=50):
        """Check, then time the kernel and the library call on the card's
        clock (a CUDA graph of 50 calls) and the host's (50 calls ending in
        a synchronize), and the plain version eagerly between CUDA events;
        ``moved`` bytes, ``ops`` f32 operations and ``sfu`` special-function
        operations give the bound."""
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        ok = tol_ok(got, want)
        ms = device_ms(kernel_fn)
        host, enqueue = host_ms(kernel_fn)
        plain_ms = events_ms(plain_fn, plain_iters)
        library_ms = library_host = library_enqueue = None
        if library_fn is not None:
            library_ms = device_ms(library_fn)
            library_host, library_enqueue = host_ms(library_fn)
        bound_ms, bound_by = bound(moved, ops, sfu)
        library = 'none' if library_fn is None else (
            f'{library_ms:.4f} ms (host {library_host:.4f} ms per call, '
            f'enqueue {library_enqueue:.4f})')
        print(f'phase 2: {name} {shape}: max_abs_err={err:.3e} '
              f'{"ok" if ok else "MISMATCH"}; kernel {ms:.4f} ms on the '
              f'card (graph), host {host:.4f} ms per call (enqueue '
              f'{enqueue:.4f}), plain {plain_ms:.4f} ms (eager), library '
              f'{library}, bound {bound_ms:.4f} ms by {bound_by} '
              f'({moved / 1e6:.2f} MB, {ops / 1e6:.2f} M f32 ops) [{card}]',
              flush=True)
        if not ok:
            fail(f'{name} disagrees with its plain version')
        report[name] = {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
                        'bound_ms': bound_ms, 'bound_by': bound_by,
                        'library_ms': library_ms, 'host_ms': host,
                        'enqueue_ms': enqueue,
                        'library_host_ms': library_host}
        return report[name]

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
    # Encode operations per (sample, level): per corner 2 weight products
    # and 2 features x (multiply + add); gradients: 2 weight products and
    # 2 features x (product + atomic add). A forward's bytes count the
    # table entries its samples reach (entry_bytes), not the whole table.
    # Each (tile, level) block of #1 stages its window in shared memory
    # when it fits FWD_WIN_ROWS rows; at the library's 2^14 every
    # morton-sorted window does.
    lay = window_layout(config)
    share = float(window_fwd_paths(win).float().mean())
    line = record('hash_window_fwd', got, want,
                  lambda a, b: bool(torch.allclose(a, b, rtol=0.0,
                                                   atol=1e-5)),
                  lambda: hash_window_fwd(table, pos, lo, win, config),
                  lambda: hash_window_fwd_plain(table, pos, lo, win, config),
                  f'table (16,2,128,128) x {n} samples, {share:.3f} of '
                  f'windows staged', nbytes(pos, lo, win, got) + entry_bytes(
                      _exact_corners(pos, lay, lv, lo, win)[0]
                      for lv in range(16)),
                  16 * n * 8 * 6)
    line['resident_share'] = share
    # The same call on the 0-row build, every block gathering.
    name = WINDOW_FWD_GLOBAL[0]

    def gathered():
        return hash_window._launch_fwd(name, table, pos, lo, win, config,
                                       window_global_lib)
    equal = bool(torch.equal(got, gathered()))
    line['global_build_ms'] = device_ms(gathered)
    line['global_build_equal'] = equal
    print(f'phase 2: hash_window_fwd {n} samples: the 0-row build (every '
          f'block gathering) {line["global_build_ms"]:.4f} ms on the card; '
          f'outputs {"equal" if equal else "DIFFER"} [{card}]', flush=True)
    if not equal:
        fail('hash_window_fwd: the staged and the gathered windows differ')
    if share != 1.0:
        fail('#1: every morton-sorted window of a serving chunk should fit '
             'in shared memory')

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
    got = block_probe_cells(*args)
    record('block_probe', got, block_probe_cells_plain(*args),
           lambda a, b: bool(torch.equal(a, b)),
           lambda: block_probe_cells(*args),
           lambda: block_probe_cells_plain(*args),
           f'table {tuple(bits.shape)} x {m} probes',
           nbytes(bits, cx, cy, cz, g, got), 0)

    # 2b. block_probe_xyz, the marcher's probe from world planes in one
    # launch: the candidate pass's 344,064 probes along rays into the box,
    # the last of them on every cascade and cell boundary +-1 ulp;
    # cascaded at SCALE 1.0 on the same table, and over one grid at SCALE
    # 0.5. Bit-exact against the plain composition; the parent's
    # composition (PyTorch operations, then block_probe_cells) is timed
    # beside it (`composition_ms`). Bytes: the three planes, the output and
    # the table once.
    center = torch.zeros(3, device=dev)
    px, py, pz = probe_points(m, 1.0, seed=4,
                              edges=boundary_values(1.0, cascades, res))
    args = (bits, px, py, pz, center, 1.0, res, cascades, cap)

    def composition():
        c, cx, cy, cz = _cascade_cell_coords(px, py, pz, center, 1.0, res,
                                             cascades)
        return block_probe_cells(bits, cx, cy, cz, c, res, cap,
                                 num_grids=cascades)
    got = occupancy_probe_block_cascaded_xyz(*args)
    line = record('block_probe_xyz', got,
                  occupancy_probe_block_cascaded_xyz_plain(*args),
                  lambda a, b: bool(torch.equal(a, b)) and bool(
                      torch.equal(a, composition())),
                  lambda: occupancy_probe_block_cascaded_xyz(*args),
                  lambda: occupancy_probe_block_cascaded_xyz_plain(*args),
                  f'cascaded, {cascades} x {res}^3, table '
                  f'{tuple(bits.shape)} x {m} world points',
                  nbytes(bits, px, py, pz, got), 0)
    line['composition_ms'] = device_ms(composition)
    print(f'phase 2: block_probe_xyz: the parent\'s composition '
          f'{line["composition_ms"]:.4f} ms on the card (graph) [{card}]',
          flush=True)
    flags1 = torch.from_numpy(shell_density_grid(res, 1, 0.5) > 0).to(dev)
    bits1 = build_block_bitfield(flags1, res, cap)
    amin, amax = center - 0.5, center + 0.5
    px, py, pz = probe_points(m, 0.5, seed=5,
                              edges=boundary_values(0.5, 1, res))
    args = (bits1, px, py, pz, amin, amax, res, cap)
    got = occupancy_probe_block_aabb_xyz(*args)
    aabb = record('block_probe_xyz', got,
                  occupancy_probe_block_aabb_xyz_plain(*args),
                  lambda a, b: bool(torch.equal(a, b)),
                  lambda: occupancy_probe_block_aabb_xyz(*args),
                  lambda: occupancy_probe_block_aabb_xyz_plain(*args),
                  f'one grid, {res}^3, table {tuple(bits1.shape)} x {m} '
                  f'world points', nbytes(bits1, px, py, pz, got), 0)
    report['block_probe_xyz'] = line
    line[f'aabb_{m}'] = aabb

    # 2c. xbar_gather, #4's generic entry, as the dense probe (PROBE_MODE
    # 'dense') calls it: the words of 2 cascades of 128^3 cells (the shell
    # grid above, downsampled as the renderer does: (2, 512, 128) int32,
    # 512 KiB, L2-resident) at the candidate pass's 344,064 probes, the
    # last on every cascade and cell boundary +-1 ulp; bit-exact, also on
    # the table's f32 view; bytes: the ids read and the words written. Then
    # the whole dense probe on the card against the CPU on the same points.
    dense = downsample_occupancy_cascaded(flags.float(), res, res, 0.5,
                                          cascades)
    px, py, pz = probe_points(m, 1.0, seed=6,
                              edges=boundary_values(1.0, cascades, res))
    c, cx, cy, cz = _cascade_cell_coords(px, py, pz, center, 1.0, res,
                                         cascades)
    local = (cx * res + cy) * res + cz
    words = dense.reshape(-1, 128)
    word_idx = (c * (dense.shape[1] * 128) + (local >> 5)).reshape(-1)
    word_idx64 = word_idx.long()
    got = xbar_gather(words, word_idx)
    line = record('xbar_gather', got, xbar_gather_plain(words, word_idx),
                  lambda a, b: bool(torch.equal(a, b)),
                  lambda: xbar_gather(words, word_idx),
                  lambda: xbar_gather_plain(words, word_idx),
                  f'table {tuple(words.shape)} int32 x {m} ids (the dense '
                  f'probe of {cascades} x {res}^3)', nbytes(word_idx, got), 0,
                  lambda: torch.take(words, word_idx64))
    as_f32 = words.view(torch.float32)
    if not torch.equal(xbar_gather(as_f32, word_idx).view(torch.int32),
                       xbar_gather_plain(as_f32, word_idx).view(torch.int32)):
        fail('xbar_gather moved the bits of an f32 table inexactly')
    args = (dense, px, py, pz, center, 1.0, res)
    on_card = occupancy_probe_cascaded_xyz(*args)
    on_cpu = occupancy_probe_cascaded_xyz(*(
        a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
    if not torch.equal(on_card.cpu(), on_cpu):
        fail('the dense cascaded probe differs between the card and the CPU')
    line['dense_probe_ms'] = device_ms(
        lambda: occupancy_probe_cascaded_xyz(*args))
    print(f'phase 2: xbar_gather: f32 view bit-exact; the dense cascaded '
          f'probe on the card equals the CPU\'s on {m} points '
          f'({int(on_cpu.sum())} occupied), {line["dense_probe_ms"]:.4f} ms '
          f'on the card (graph) [{card}]', flush=True)

    # 3./4. segment gather / scatter-add over one chunk's 24,576 blocks.
    nb, rays, rows = 24576, 1536, (1536 + 1 + 127) // 128
    ids = np.sort(rng.integers(0, rays + 1, nb)).astype(np.int32)
    idx = torch.from_numpy(ids[None]).to(dev)
    seg_table = torch.from_numpy(rng.normal(size=(1, 1, rows, 128)).astype(
        np.float32)).to(dev)
    # The library calls take the same indices as int64.
    idx64 = idx[0].long()
    got = seg_gather(idx, seg_table)
    line = record('seg_gather', got, seg_gather_plain(idx, seg_table),
                  lambda a, b: bool(torch.equal(a, b)),
                  lambda: seg_gather(idx, seg_table),
                  lambda: seg_gather_plain(idx, seg_table),
                  f'(1,1,{rows},128) x {nb}', nbytes(idx, seg_table, got), 0,
                  lambda: torch.take(seg_table, idx64))
    # #6 on ids in [-2 size, 2 size): those in [-size, -1] count from the
    # end and the others clamp into [0, size - 1], as the oracle's JAX
    # indexing does; bit-exact. From a generator of its own, so the later
    # inputs stay as they were.
    size = rows * 128
    idx_neg = torch.from_numpy(np.random.default_rng(8).integers(
        -2 * size, 2 * size, (1, nb)).astype(np.int32)).to(dev)
    got = seg_gather(idx_neg, seg_table)
    line['negative_and_out_of_range'] = dict(record(
        'seg_gather', got, seg_gather_plain(idx_neg, seg_table),
        lambda a, b: bool(torch.equal(a, b)),
        lambda: seg_gather(idx_neg, seg_table),
        lambda: seg_gather_plain(idx_neg, seg_table),
        f'(1,1,{rows},128) x {nb}, ids in [-2 size, 2 size)',
        nbytes(idx_neg, seg_table, got), 0))
    report['seg_gather'] = line
    vals = torch.from_numpy(rng.uniform(0, 1, (1, 5, nb)).astype(
        np.float32)).to(dev)

    def scatter_close(idx_s, vals_s, rows_s):
        # Within 1e-5 of the sum of |g| per entry, plus 1e-6: rtol 1e-5 /
        # atol 1e-6 where the values share a sign, scaled where sums
        # cancel (atomics add in another order).
        scale = seg_scatter_add_plain(idx_s, vals_s.abs(), rows_s)
        return lambda a, b: bool(((a - b).abs() <= 1e-5 * scale + 1e-6)
                                 .all())
    got = seg_scatter_add(idx, vals, rows)
    path = seg_scatter_plan(5, nb, rows)
    line = record('seg_scatter_add', got,
                  seg_scatter_add_plain(idx, vals, rows),
                  scatter_close(idx, vals, rows),
                  lambda: seg_scatter_add(idx, vals, rows),
                  lambda: seg_scatter_add_plain(idx, vals, rows),
                  f'(1,5,{nb}) -> (1,5,{rows},128), sorted, {path}',
                  nbytes(idx, vals, got), 5 * nb,
                  lambda: torch.zeros((5, rows * 128), device=dev).index_add_(
                      1, idx64, vals[0]))
    line['path'] = path
    # #7's contract beyond the serving path: ids in any order, a tenth of
    # them negative (counted from the end, as the oracle's NumPy indexing
    # does) or past either end (dropped), signed values, on the plan's
    # path for the shape (fused); and a training step's call (8,192
    # blocks over 512 rays, signed values), which the plan sends down the
    # atomic path (memset and one atomic per element).
    ids = rng.integers(0, rays + 1, nb)
    bad = rng.uniform(size=nb) < 0.1
    ids[bad] = rng.choice([-1, -1000, rows * 128, rows * 128 + 7],
                          int(bad.sum()))
    idx_any = torch.from_numpy(ids.astype(np.int32)[None]).to(dev)
    # From a generator of their own, so the later inputs stay as they were.
    rng_s = np.random.default_rng(7)
    signed = torch.from_numpy(rng_s.uniform(-1, 1, (1, 5, nb)).astype(
        np.float32)).to(dev)
    nt, rays_t = 8192, 512
    rows_t = (rays_t + 1 + 127) // 128
    idx_t = torch.from_numpy(np.sort(rng_s.integers(0, rays_t + 1, nt))
                             .astype(np.int32)[None]).to(dev)
    vals_t = torch.from_numpy(rng_s.uniform(-1, 1, (1, 5, nt)).astype(
        np.float32)).to(dev)
    for key, (idx_s, vals_s, rows_s), what in (
            ('unsorted_out_of_range', (idx_any, signed, rows),
             'unsorted, 10% negative or past the end, signed'),
            ('atomic_path', (idx_t, vals_t, rows_t), 'sorted, signed')):
        m_s = vals_s.shape[2]
        path_s = seg_scatter_plan(5, m_s, rows_s)
        got = seg_scatter_add(idx_s, vals_s, rows_s)
        line[key] = dict(record(
            'seg_scatter_add', got,
            seg_scatter_add_plain(idx_s, vals_s, rows_s),
            scatter_close(idx_s, vals_s, rows_s),
            lambda a=(idx_s, vals_s, rows_s): seg_scatter_add(*a),
            lambda a=(idx_s, vals_s, rows_s): seg_scatter_add_plain(*a),
            f'(1,5,{m_s}) -> (1,5,{rows_s},128), {what}, {path_s}',
            nbytes(idx_s, vals_s, got), 5 * m_s), path=path_s)
    if (line['unsorted_out_of_range']['path'], line['atomic_path']['path']
            ) != ('fused', 'atomic'):
        fail('#7: the plan should take the fused path at the serving '
             'chunk and the atomic path at a training step')
    report['seg_scatter_add'] = line

    # 5.-7. the training encode: one step's 65,536 morton-sorted samples
    # (TARGET_BATCH_SIZE) on the full-width table, 4 stochastic corners with
    # saved (16, 4, 65536) streams, and both table gradients. The gradients
    # sum with atomics in a varying order: rtol 1e-4, atol 1e-5 * max|plain|.
    n = 65536
    pos = torch.from_numpy(rng.uniform(0.2, 0.8, (n, 3)).astype(
        np.float32)).to(dev)
    pos = pos[torch.sort(morton_sort_keys(pos), stable=True).indices]
    pos = pos.contiguous()
    lo, win = window_bases(pos, config)
    stoch = (table, pos, lo, win, config, 4, 0x9E3779B9)
    out, s_idx, s_w = hash_window_fwd_stoch(*stoch, save=True)
    out_p, s_idx_p, s_w_p = hash_window_fwd_stoch_plain(*stoch, save=True)
    record('hash_window_fwd_stoch', out, out_p,
           lambda a, b: bool(torch.equal(s_idx, s_idx_p)) and bool(
               torch.equal(s_w, s_w_p)) and bool(
               torch.allclose(a, b, rtol=0.0, atol=1e-5)),
           lambda: hash_window_fwd_stoch(*stoch, save=True),
           lambda: hash_window_fwd_stoch_plain(*stoch, save=True),
           f'table (16,2,128,128) x {n} samples, 4 corners + saves',
           nbytes(pos, lo, win, out, s_idx, s_w) + entry_bytes(s_idx),
           16 * n * 4 * 6)
    g = torch.from_numpy(rng.normal(size=(32, n)).astype(np.float32)).to(dev)

    def scatter_ok(a, b):
        return bool(torch.allclose(a, b, rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max())))

    # #2 and #3, each level's gradient in one block's shared memory; the
    # library call is one index_add_ of the products (#2's: of its 8 exact
    # corners), made before it is timed, into a zeroed plane. Then a 2^16
    # table (512 rows a level, past a block's shared memory: the global
    # path) from the same samples, and #2 at 262,144 samples, from a
    # generator of its own, so the later inputs stay as they were.
    def exact(g, pos, lo, win, cfg, rows, plain_iters=50):
        got = hash_window_bwd(g, pos, lo, win, cfg, rows)
        n = pos.shape[0]
        path = window_bwd_path(rows)
        return dict(record(
            'hash_window_bwd', got,
            hash_window_bwd_plain(g, pos, lo, win, cfg, rows), scatter_ok,
            lambda: hash_window_bwd(g, pos, lo, win, cfg, rows),
            lambda: hash_window_bwd_plain(g, pos, lo, win, cfg, rows),
            f'g (32,{n}) -> (16,2,{rows},128), 8 corners, {path} path',
            nbytes(g, pos, lo, win, got), 16 * n * 8 * 6,
            exact_index_add_call(g, pos, lo, win, cfg, rows),
            plain_iters=plain_iters), path=path)
    cfg16 = HashGridConfig(num_levels=16, features_per_level=2,
                           log2_table_size=16, base_resolution=16,
                           target_resolution=2048, anchor_stride=8)
    lo16, win16 = window_bases(pos, cfg16)
    line = exact(g, pos, lo, win, config, 128)
    line[f'global_2^16_{n}'] = exact(g, pos, lo16, win16, cfg16, 512)
    rng_e = np.random.default_rng(12)
    n_e = 262144
    pos_e = torch.from_numpy(rng_e.uniform(0.2, 0.8, (n_e, 3)).astype(
        np.float32)).to(dev)
    pos_e = pos_e[torch.sort(morton_sort_keys(pos_e), stable=True).indices]
    pos_e = pos_e.contiguous()
    lo_e, win_e = window_bases(pos_e, config)
    g_e = torch.from_numpy(rng_e.normal(size=(32, n_e)).astype(
        np.float32)).to(dev)
    line[f'level_{n_e}'] = exact(g_e, pos_e, lo_e, win_e, config, 128,
                                 plain_iters=3)
    report['hash_window_bwd'] = line
    del pos_e, g_e, lo_e, win_e

    def cached(g, s_idx, s_w, rows, label):
        got = hash_window_bwd_cached(g, s_idx, s_w, rows)
        _, nc, n = s_idx.shape
        return record(
            'hash_window_bwd_cached', got,
            hash_window_bwd_cached_plain(g, s_idx, s_w, rows), scatter_ok,
            lambda: hash_window_bwd_cached(g, s_idx, s_w, rows),
            lambda: hash_window_bwd_cached_plain(g, s_idx, s_w, rows),
            f'g (32,{n}) + streams (16,{nc},{n}) -> (16,2,{rows},128), '
            f'{label}', nbytes(g, s_idx, s_w, got), 16 * n * nc * 6,
            index_add_call(g, s_idx, s_w, rows))
    line = cached(g, s_idx, s_w, 128, 'level-resident')
    table16 = torch.from_numpy(rng.uniform(-1, 1, (16, 2, 512, 128)).astype(
        np.float32)).to(dev)
    _, idx16, w16 = hash_window_fwd_stoch(table16, pos, lo16, win16, cfg16,
                                          4, 0x9E3779B9, save=True)
    line[f'global_2^16_{n}'] = cached(g, idx16, w16, 512, 'global path')
    report['hash_window_bwd_cached'] = line
    del table16, idx16, w16

    # #8/#9: the parity config's step, 262,144 morton-sorted samples on the
    # (16,2,4096,128) = 2^19 cell table (64 MiB, larger than the L2). The
    # coarse levels address only part of their 4096 rows and the windows
    # keep the rest out of reach: the forward's bound counts the entries
    # read; the backward still writes the whole table.
    cell_cfg = HashGridConfig(num_levels=16, features_per_level=2,
                              log2_table_size=19, base_resolution=16,
                              target_resolution=2048, anchor_stride=8)
    n = 262144
    cell_table = torch.from_numpy(rng.uniform(
        -1, 1, (16, 2, 4096, 128)).astype(np.float32)).to(dev)
    pos = torch.from_numpy(rng.uniform(0.2, 0.8, (n, 3)).astype(
        np.float32)).to(dev)
    pos = pos[torch.sort(morton_sort_keys(pos), stable=True).indices]
    pos = pos.contiguous()
    lo, win = cell_window_bases(pos, cell_cfg)
    cell = (pos, lo, win, cell_cfg)

    def record_cell_fwd(cell, what=''):
        """#8 on one input set, a block per (sub-block, level) gathering its
        samples' corners: each level's windows, and the output against the
        plain version."""
        p, lo_c, win_c, _ = cell
        windows = cell_window_report(win_c)['levels']
        n_c = p.shape[0]
        print(f'phase 2: hash_cell_fwd {n_c} samples{what}: windows per '
              f'level (base rows min/median/max): ' +
              '; '.join(f'{lv}: {w["min"]}/{w["median"]:g}/{w["max"]}'
                        for lv, w in enumerate(windows)), flush=True)
        got = hash_cell_fwd(cell_table, *cell)
        return dict(record(
            'hash_cell_fwd', got, hash_cell_fwd_plain(cell_table, *cell),
            lambda a, b: bool(torch.allclose(a, b, rtol=0.0, atol=1e-5)),
            lambda: hash_cell_fwd(cell_table, *cell),
            lambda: hash_cell_fwd_plain(cell_table, *cell),
            f'table (16,2,4096,128) x {n_c} samples{what}',
            nbytes(p, lo_c, win_c, got) + entry_bytes(
                _cell_corners(p, cell_layout(cell_cfg), lv, lo_c, win_c)[0]
                for lv in range(16)),
            16 * n_c * 8 * 6))
    fwd_line = record_cell_fwd(cell)
    # A serving chunk's 196,608 samples, from a generator of their own so
    # the later inputs stay as they were.
    pos_s = torch.from_numpy(np.random.default_rng(9).uniform(
        0.2, 0.8, (196608, 3)).astype(np.float32)).to(dev)
    pos_s = pos_s[torch.sort(morton_sort_keys(pos_s), stable=True).indices]
    pos_s = pos_s.contiguous()
    fwd_line['serving_chunk_196608'] = record_cell_fwd(
        (pos_s, *cell_window_bases(pos_s, cell_cfg), cell_cfg),
        ', a serving chunk')
    report['hash_cell_fwd'] = fwd_line
    del pos_s
    g = torch.from_numpy(rng.normal(size=(32, n)).astype(np.float32)).to(dev)
    # #9 as the wrapper runs it (each (sub-block, level) block keeps its
    # window's gradient in shared memory when the window fits, else adds
    # to the table with global atomics), then with one level that keeps
    # some windows resident (level 12) forced onto the global path.
    paths = cell_window_report(win)
    print(f'phase 2: hash_cell_bwd windows per level (base rows min/median/'
          f'max, share of sub-blocks resident at {BWD_WIN_ROWS} rows): ' +
          '; '.join(f'{lv}: {w["min"]}/{w["median"]:g}/{w["max"]} '
                    f'{w["resident_share"]:.3f}'
                    for lv, w in enumerate(paths['levels'])) +
          f'; all levels {paths["resident_share"]:.3f}', flush=True)
    want = hash_cell_bwd_plain(g, *cell, 4096)
    got = hash_cell_bwd(g, *cell, 4096)
    line = record('hash_cell_bwd', got, want, scatter_ok,
                  lambda: hash_cell_bwd(g, *cell, 4096),
                  lambda: hash_cell_bwd_plain(g, *cell, 4096),
                  f'g (32,{n}) -> (16,2,4096,128), 8 corners, '
                  f'{paths["resident_share"]:.3f} of blocks resident',
                  nbytes(g, pos, lo, win, got), 16 * n * 8 * 6)
    line['resident_share'] = paths['resident_share']
    if not bool(cell_bwd_paths(win)[12].any()):
        fail('level 12 should keep some windows in shared memory')
    got = hash_cell_bwd(g, *cell, 4096, global_levels=(12,))
    line['level_12_global'] = dict(record(
        'hash_cell_bwd', got, want, scatter_ok,
        lambda: hash_cell_bwd(g, *cell, 4096, global_levels=(12,)),
        lambda: hash_cell_bwd_plain(g, *cell, 4096),
        f'g (32,{n}) -> (16,2,4096,128), 8 corners, level 12 forced '
        f'global', nbytes(g, pos, lo, win, got), 16 * n * 8 * 6,
        plain_iters=5))
    line['level_12_global']['resident_share'] = float(
        cell_bwd_paths(win, (12,)).float().mean())
    report['hash_cell_bwd'] = line

    # #10/#11: the crossbar config's step, 65,536 samples on the
    # (16,2,128,128) table, exact (serving) and 4 stochastic corners
    # (training), a serving chunk's 196,608 (#10 only), then D-NeRF's step,
    # 262,144 samples, exact and 4 corners; the stochastic corners and
    # weights must be bit-equal. Each takes the path its plan gives it: the
    # level-resident path at these sizes (the level's table, #10, or its
    # gradient, #11, staged in shared memory). #11's bytes: cotangent and
    # positions read, the table written.
    xbar_lines = {}
    for n in (262144, 196608, 65536):
        plain_iters = 5 if n > 65536 else 50
        pos = torch.from_numpy(rng.uniform(0.2, 0.8, (n, 3)).astype(
            np.float32)).to(dev)
        g = torch.from_numpy(rng.normal(size=(n, 32)).astype(
            np.float32)).to(dev)
        for nc in (4, 0):
            args = (table, pos, config, nc, 0x5EED)
            out, x_idx, x_w = hash_xbar_fwd(*args, save=True)
            out_p, x_idx_p, x_w_p = hash_xbar_fwd_plain(*args, save=True)
            mode = 'exact' if nc == 0 else f'{nc} corners'
            path = xbar_fwd_plan(config, n).path
            xbar_lines['hash_xbar_fwd', n, nc] = dict(record(
                'hash_xbar_fwd', out, out_p,
                lambda a, b: bool(torch.equal(x_idx, x_idx_p)) and bool(
                    torch.equal(x_w, x_w_p)) and bool(
                    torch.allclose(a, b, rtol=0.0, atol=1e-5)),
                lambda: hash_xbar_fwd(*args),
                lambda: hash_xbar_fwd_plain(*args),
                f'table (16,2,128,128) x {n} samples, {mode}, {path}',
                nbytes(pos, out) + entry_bytes(x_idx),
                16 * n * (nc or 8) * 6, plain_iters=plain_iters), path=path)
            if n == 196608:
                continue
            got = hash_xbar_bwd(g, pos, config, 128, nc, 0x5EED)
            xbar_lines['hash_xbar_bwd', n, nc] = dict(record(
                'hash_xbar_bwd', got,
                hash_xbar_bwd_plain(g, pos, config, 128, nc, 0x5EED),
                scatter_ok,
                lambda: hash_xbar_bwd(g, pos, config, 128, nc, 0x5EED),
                lambda: hash_xbar_bwd_plain(g, pos, config, 128, nc, 0x5EED),
                f'g ({n},32) -> (16,2,128,128), {mode}, '
                f'{xbar_bwd_plan(config, n, pos=False).path}',
                nbytes(g, pos, got), 16 * n * (nc or 8) * 6,
                plain_iters=plain_iters))

    # #12 at both sample counts, and #11 and #12 from one call at D-NeRF's
    # (exact, its default, and 4 corners), each against the plain versions
    # on the same bits: the position gradient equal (the kernels keep the
    # plain version's order of operations and sum the levels in order),
    # the table gradient as scatter_ok allows. #12's bytes: positions,
    # cotangent and dpos, and the table entries the samples reach;
    # operations per (sample, level, corner): g . v (3), the other dims'
    # factor products (3), 3 per dim for the product and 1 for the sum (12).
    def xbar_bwd_pair(tag, xtable, xconfig, n, nc):
        """#12 and the fused entry on one input set; their report lines."""
        rows = xtable.shape[2]
        pos = torch.from_numpy(rng.uniform(0.2, 0.8, (n, 3)).astype(
            np.float32)).to(dev)
        g = torch.from_numpy(rng.normal(size=(n, 32)).astype(
            np.float32)).to(dev)
        args = (xtable, pos, g, xconfig, nc, 0x5EED)
        mode = 'exact' if nc == 0 else f'{nc} corners'
        plan = xbar_bwd_plan(xconfig, n)
        want_pos = hash_xbar_bwd_pos_plain(*args)
        got = hash_xbar_bwd_pos(*args)
        _, x_idx, _ = hash_xbar_fwd(xtable, pos, xconfig, nc, 0x5EED,
                                    save=True)
        moved_pos = nbytes(pos, g, got) + entry_bytes(x_idx)
        line_pos = dict(record(
            'hash_xbar_bwd_pos', got, want_pos,
            lambda a, b: bool(torch.equal(a, b)),
            lambda: hash_xbar_bwd_pos(*args),
            lambda: hash_xbar_bwd_pos_plain(*args),
            f'{tag}g ({n},32) -> dpos ({n},3), {mode}, '
            f'{xbar_bwd_plan(xconfig, n, tab=False).path}',
            moved_pos, 16 * n * (nc or 8) * 18, plain_iters=5))
        dtab, dpos = hash_xbar_bwd_fused(*args)
        want_tab = hash_xbar_bwd_plain(g, pos, xconfig, rows, nc, 0x5EED)
        print(f'phase 2: hash_xbar_bwd_fused {tag}{n} samples, {mode}: '
              f'dpos max_abs_err={float((dpos - want_pos).abs().max()):.3e} '
              f'(equal {bool(torch.equal(dpos, want_pos))})', flush=True)

        def plain_both():
            return (hash_xbar_bwd_plain(g, pos, xconfig, rows, nc, 0x5EED),
                    hash_xbar_bwd_pos_plain(*args))
        line_both = dict(record(
            'hash_xbar_bwd_fused', dtab, want_tab,
            lambda a, b: scatter_ok(a, b) and bool(torch.equal(dpos,
                                                               want_pos)),
            lambda: hash_xbar_bwd_fused(*args), plain_both,
            f'{tag}g ({n},32) -> (16,2,{rows},128) + dpos ({n},3), {mode}, '
            f'{plan.path}',
            moved_pos + nbytes(dtab), 16 * n * (nc or 8) * 24,
            plain_iters=5))
        return line_pos, line_both

    for n, nc in ((65536, 4), (65536, 0), (262144, 4), (262144, 0)):
        (xbar_lines['hash_xbar_bwd_pos', n, nc],
         xbar_lines['hash_xbar_bwd_fused', n, nc]) = xbar_bwd_pair(
            '', table, config, n, nc)
    # The gather path: a 2^16-entry crossbar table (16,2,512,128) needs 384
    # KiB of shared memory per level, past a block's 227 KB.
    big_config = HashGridConfig(num_levels=16, features_per_level=2,
                                log2_table_size=16, base_resolution=16,
                                target_resolution=2048)
    big_table = torch.from_numpy(rng.uniform(-1, 1, (16, 2, 512, 128)).astype(
        np.float32)).to(dev)
    if xbar_bwd_plan(big_config, 262144).path != 'gather':
        fail('a 2^16 crossbar table should take the gather path')
    gather = xbar_bwd_pair('2^16 table, ', big_table, big_config, 262144, 0)
    # The report's lines: #10 and #11 at the Instant-NGP step's 65,536,
    # exact; #12 and the fused entry at D-NeRF's 262,144, exact; the other
    # shapes and modes ride along (#10's with the path each took).
    main_shape = {'hash_xbar_fwd': 65536, 'hash_xbar_bwd': 65536,
                  'hash_xbar_bwd_pos': 262144, 'hash_xbar_bwd_fused': 262144}
    # #10 at the occupancy grid's warm-up refresh, every cell of 2 cascades
    # of 128^3 in one call (exact corners).
    n = 2 * 128 ** 3
    pos = torch.from_numpy(rng.uniform(0.0, 1 - 1e-6, (n, 3)).astype(
        np.float32)).to(dev)
    args = (table, pos, config, 0, 0)
    out, x_idx, _ = hash_xbar_fwd(*args, save=True)
    path = xbar_fwd_plan(config, n).path
    xbar_lines['hash_xbar_fwd', n, 0] = dict(record(
        'hash_xbar_fwd', out, hash_xbar_fwd_plain(*args),
        lambda a, b: bool(torch.allclose(a, b, rtol=0.0, atol=1e-5)),
        lambda: hash_xbar_fwd(*args), lambda: hash_xbar_fwd_plain(*args),
        f'table (16,2,128,128) x {n} samples, exact, {path}',
        nbytes(pos, out) + entry_bytes(x_idx), 16 * n * 8 * 6,
        plain_iters=1), path=path)
    del pos, out, x_idx
    for name, n_main in main_shape.items():
        report[name] = dict(xbar_lines[name, n_main, 0])
        for (key, n, nc), line in xbar_lines.items():
            if key == name and (n, nc) != (n_main, 0):
                report[name][f'{"exact" if nc == 0 else f"{nc}_corners"}_'
                             f'{n}'] = line
    report['hash_xbar_bwd_pos']['gather_2^16_exact_262144'] = gather[0]
    report['hash_xbar_bwd_fused']['gather_2^16_exact_262144'] = gather[1]

    # #5: the (262,144 x 4) f32 sample stream (sigma, rgb) permuted by
    # whole blocks of 8, as permute_block_channels moves it; bit-exact.
    n = 262144
    blocks = n // 8
    perm = torch.from_numpy(rng.permutation(blocks)).to(dev)
    idx = (perm[:, None] * 8 + torch.arange(8, device=dev)).reshape(-1).to(
        torch.int32)
    stream = torch.from_numpy(rng.normal(size=(n, 4)).astype(
        np.float32)).to(dev)
    got = xbar_permute(stream, idx)
    record('xbar_permute', got, xbar_permute_plain(stream, idx),
           lambda a, b: bool(torch.equal(a.view(torch.int32),
                                         b.view(torch.int32))),
           lambda: xbar_permute(stream, idx),
           lambda: xbar_permute_plain(stream, idx),
           f'({n},4) f32 rows by a block permutation', nbytes(stream, idx,
                                                               got), 0,
           lambda: torch.index_select(stream, 0, idx))
    report.update(phase2_gs_kernels(record, rng))
    return report


# The least f32 work of the composite and its gradient, counted from
# nerficg_torch/csrc/gs_tiles.cu per (entry, pixel) pair whose alpha passes
# 1/255 (an FMA is 2); the other pairs need no work, since a bound like the
# kernels' per-strip cull proves most of them zero, and are not counted.
# Both: the alpha (2 for dx, dy, 9 for the power, its clamp, a_raw and the
# threshold test: 14) and one expf at the special-function rate. Forward,
# 13 more: alpha, the weight, 3 color FMAs, acc, the depth FMA and the
# transmittance step. Backward, 54 more: the transmittance step (2), alpha
# and the weight (2), g (8), the upper test, d_alpha (4), the suffix FMA,
# d_op, d_pow (3), the 10 channel products (21) and 10 adds of the pixel
# sums.
GS_FWD_OPS = 14 + 13
GS_BWD_OPS = 14 + 54


def gs_pairs(args) -> tuple[int, int]:
    """(valid (entry, pixel) pairs, pairs whose alpha passes 1/255) of a
    composite of ``args`` = (sorted_mat, starts, counts, tiles_x,
    num_tiles, k), by the plain version's geometry; also prints the pairs
    the culled kernels walk."""
    from nerficg_torch.scripts.kernel_timing import gs_pair_counts
    pairs = gs_pair_counts(args)
    print(f'phase 2: 3DGS composite of {args[4]} tiles: {pairs["valid"]} '
          f'valid (entry, pixel) pairs, {pairs["walked"]} walked by the '
          f'per-strip cull, {pairs["passing"]} with alpha > 1/255',
          flush=True)
    return pairs['valid'], pairs['passing']


def phase2_gs_kernels(record, rng) -> dict:
    """#15 (both layouts), #16, #13 and #14 at bench.py's frame: the
    streams ``rasterize_gaussians`` builds from the 100k-Gaussian model at
    orbit pose 0, 1920x1080 (8160 tiles, k = 256, D = 6), SH degree 1 as
    bench.py renders it; a random d out for the backward. #15 (16-wide)
    and #16 again on a 400x400 frame of the same model (625 tiles), the GS
    training config's image size. Then the frontend pair
    (``phase2_gs_frontend``) and the entry gather's pair
    (``phase2_gs_gather``). Returns the report's lines of #15 and #16
    (each with its 400x400 sub-entry) and of both pairs."""
    import torch

    from nerficg_torch.ops import gs_tiles_kernel as gtk
    from nerficg_torch.scripts.kernel_timing import gs_frame, gs_model

    model = gs_model('cuda')
    args8 = gs_frame(model, 1920, 1080, packed=True)
    args16 = gs_frame(model, 1920, 1080)

    def forward_close(a, b):
        return bool(torch.allclose(a, b, rtol=0.0, atol=1e-5))

    num_tiles = args16[4]
    print(f'phase 2: 3DGS stream at 1920x1080: {num_tiles} tiles, '
          f'{int(args16[2].sum())} entries', flush=True)
    pairs, passing = gs_pairs(args16)
    entries = pairs // gtk.P
    out_bytes = num_tiles * gtk.OUT_ROWS * gtk.P * 4
    seg = (args16[1].numel() + args16[2].numel()) * 4    # starts, counts
    got = gtk.gs_composite_fwd_packed(*args8)
    record('gs_composite_fwd_packed', got,
           gtk.gs_composite_fwd_plain(*args8, save_tacc=False),
           forward_close, lambda: gtk.gs_composite_fwd_packed(*args8),
           lambda: gtk.gs_composite_fwd_plain(*args8, save_tacc=False),
           f'packed stream (8,{args8[0].shape[1]}) -> ({num_tiles},5,256)',
           entries * 5 * 4 + seg + out_bytes, GS_FWD_OPS * passing,
           sfu=passing, plain_iters=5)

    counts_1080 = pairs, passing
    tacc, line_1080_fwd = record_gs_fwd(record, args16, '1920x1080',
                                        counts_1080)
    dout, line_1080 = record_gs_bwd(record, rng, args16, tacc, '1920x1080',
                                    counts_1080)
    frame_400 = gs_frame(model, 400, 400)
    counts_400 = gs_pairs(frame_400)
    tacc_400, line_400_fwd = record_gs_fwd(record, frame_400, '400x400',
                                           counts_400)
    _, line_400 = record_gs_bwd(record, rng, frame_400, tacc_400, '400x400',
                                counts_400)
    del frame_400, tacc_400
    lines = {'gs_composite_fwd': {**line_1080_fwd,
                                  'frame_400x400': line_400_fwd}}

    # #13/#14: the same frame as per-tile slot windows (T, 256, 10), the
    # layout of composite_tiles, with row-major origins; the same valid and
    # passing pairs. #13's rows 0-4 must equal #15's composite of the same
    # tiles. Bytes: the slots within each count, counts and origins; the
    # (T, 8, 256) output (#13) or the 5 d out rows the gradient reads and
    # the whole (T, 256, 10) d slots (#14).
    slots, counts, origins = slot_windows(args16)
    got = gtk.gs_tiles_fwd(slots, counts, origins)
    out, _ = gtk.gs_composite_fwd(*args16)
    slot_in = entries * 10 * 4 + nbytes(counts, origins)
    record('gs_tiles_fwd', got, gtk.gs_tiles_fwd_plain(slots, counts,
                                                       origins),
           lambda a, b: forward_close(a, b) and forward_close(a[:, :5], out)
           and not bool(a[:, 5:].any()),
           lambda: gtk.gs_tiles_fwd(slots, counts, origins),
           lambda: gtk.gs_tiles_fwd_plain(slots, counts, origins),
           f'slots {tuple(slots.shape)} -> ({num_tiles},8,256)',
           slot_in + nbytes(got), GS_FWD_OPS * passing, sfu=passing,
           plain_iters=5)
    dout8 = torch.nn.functional.pad(dout, (0, 0, 0, 3))
    got = gtk.gs_tiles_bwd(slots, counts, origins, dout8)
    record('gs_tiles_bwd', got,
           gtk.gs_tiles_bwd_plain(slots, counts, origins, dout8),
           lambda a, b: bool(torch.allclose(a, b, rtol=1e-3, atol=2e-3)),
           lambda: gtk.gs_tiles_bwd(slots, counts, origins, dout8),
           lambda: gtk.gs_tiles_bwd_plain(slots, counts, origins, dout8),
           f'd out ({num_tiles},8,256) -> d slots {tuple(slots.shape)}',
           slot_in + out_bytes + nbytes(got), GS_BWD_OPS * passing,
           sfu=passing, plain_iters=3)
    lines['gs_composite_bwd'] = {**line_1080, 'frame_400x400': line_400}
    lines.update(phase2_gs_frontend(record))
    lines.update(phase2_gs_gather(record))
    return lines


# The Mip-NeRF 360 cell's Gaussians (734 MB / 236 B) and its views.
GS360_GAUSSIANS = 3112960
GS360_VIEW = (1237, 822)


def gs360_frontend_inputs(width: int, height: int, seed: int = 0):
    """The frontend's inputs at the Mip-NeRF 360 cell's size: 3,112,960
    Gaussians in U(-2, 2)^3 with log scales U(-6, -2), random quaternions,
    opacities and 16 SH coefficients, the last 1% padding rows, seen from
    an orbit pose at width x height: (params, w2c, cam_pos, intrinsics)."""
    import numpy as np
    import torch

    from nerficg_torch.scripts.kernel_timing import orbit_view
    n, dev = GS360_GAUSSIANS, torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(seed)
    params = {
        'positions': torch.rand(n, 3, generator=g, device=dev) * 4 - 2,
        'scales': torch.rand(n, 3, generator=g, device=dev) * 4 - 6,
        'rotations': torch.randn(n, 4, generator=g, device=dev),
        'opacities': torch.randn(n, 1, generator=g, device=dev),
        'features_dc': 0.5 * torch.randn(n, 1, 3, generator=g, device=dev),
        'features_rest': 0.2 * torch.randn(n, 15, 3, generator=g,
                                           device=dev)}
    pad = n - n // 100
    params['positions'][pad:] = 0.0
    params['scales'][pad:] = -10.0
    params['rotations'][pad:] = 0.0
    params['opacities'][pad:] = -15.0
    view = orbit_view(0.3, width, height)
    cam = view.camera
    intrinsics = (float(cam.focal_x), float(cam.focal_y), float(cam.center_x),
                  float(cam.center_y), int(cam.width), int(cam.height))
    w2c = torch.as_tensor(np.asarray(view.w2c, np.float32), device=dev)
    cam_pos = torch.as_tensor(np.asarray(view.position, np.float32),
                              device=dev)
    return params, w2c, cam_pos, intrinsics


def phase2_gs_frontend(record) -> dict:
    """The frontend pair at the Mip-NeRF 360 cell's 3,112,960 Gaussians
    and 4 SH bands: the forward on a 1920x1080 orbit view, held bit for bit
    to the plain version; the backward on a 1237x822 view, output gradients
    random on the visible Gaussians (zero elsewhere, as the rasterizer
    gives them), within 1e-4 relative Frobenius of autograd of the plain
    version in every parameter. Bytes: the 236 B of raw parameters a
    Gaussian, and the 45 B of outputs (forward) or the 40 B of output
    gradients and 236 B of parameter gradients (backward); operations
    ~420 and ~840 a Gaussian (nerfbench/roofline.py GS_FRONTEND_*)."""
    import torch

    from nerficg_torch.ops import gaussian as gsf
    n = GS360_GAUSSIANS
    params, w2c, cam_pos, intrinsics = gs360_frontend_inputs(1920, 1080)
    args = (params, w2c, cam_pos, intrinsics, 4)
    got = gsf.gs_frontend_fwd(*args)
    want = gsf.gs_frontend_plain(*args)

    def flat(out):
        return torch.cat([out[k].float().reshape(-1)
                          for k in gsf.FRONTEND_OUTPUTS])

    def plain_fwd():
        with torch.no_grad():
            return gsf.gs_frontend_plain(*args)
    lines = {'gs_frontend_fwd': dict(record(
        'gs_frontend_fwd', flat(got), flat(want),
        lambda a, b: all(torch.equal(got[k], want[k])
                         for k in gsf.FRONTEND_OUTPUTS),
        lambda: gsf.gs_frontend_fwd(*args), plain_fwd,
        f'{n} Gaussians, 4 bands -> the rasterizer inputs at 1920x1080',
        n * (236 + 45), n * 420))}
    del got, want

    params, w2c, cam_pos, intrinsics = gs360_frontend_inputs(*GS360_VIEW, 1)
    args = (params, w2c, cam_pos, intrinsics, 4)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    out = gsf.gs_frontend_plain(leaves, *args[1:])
    vis = out['visible'].float()
    g = torch.Generator(device='cuda').manual_seed(2)
    grads = {k: torch.randn(out[k].shape, generator=g, device='cuda') *
             (vis if out[k].ndim == 1 else vis[:, None])
             for k in ('means2d', 'depths', 'conics', 'colors', 'opacities')}
    loss = sum((out[k] * grads[k]).sum() for k in grads)
    want = dict(zip(leaves, torch.autograd.grad(loss,
                                                list(leaves.values()))))
    del out, loss
    got = gsf.gs_frontend_bwd(*args, grads)

    def close(a, b):
        return all(float((got[k] - want[k]).norm()) <=
                   1e-4 * float(want[k].norm())
                   for k in gsf.FRONTEND_PARAMS)

    def plain_bwd():
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        out = gsf.gs_frontend_plain(leaves, *args[1:])
        torch.autograd.grad(sum((out[k] * grads[k]).sum() for k in grads),
                            list(leaves.values()))
    lines['gs_frontend_bwd'] = dict(record(
        'gs_frontend_bwd', torch.cat([got[k].reshape(-1) for k in got]),
        torch.cat([want[k].reshape(-1) for k in got]), close,
        lambda: gsf.gs_frontend_bwd(*args, grads), plain_bwd,
        f'{n} Gaussians, 4 bands, d outputs at 1237x822 -> d parameters',
        n * (236 + 40 + 236), n * 840, plain_iters=3))
    return lines


def _parent_stream(attrs, perm, e_pad: int):
    """The 16-wide stream as the port composed it before the gather
    kernels: the ten attribute rows stacked, expanded D times, gathered by
    ``perm`` and padded; autograd's backward of it is index_put_ with
    accumulate."""
    import torch
    means2d, conics, opacities, colors, depths = attrs
    rows = torch.stack([means2d[:, 0], means2d[:, 1], conics[:, 0],
                        conics[:, 1], conics[:, 2], opacities, colors[:, 0],
                        colors[:, 1], colors[:, 2], depths])
    dup = perm.shape[0] // rows.shape[1]
    channels = rows[:, None, :].expand(-1, dup, -1).reshape(10, -1)
    return torch.nn.functional.pad(channels[:, perm],
                                   (0, e_pad - perm.shape[0], 0, 6))


def phase2_gs_gather(record) -> dict:
    """The entry gather's pair at the Mip-NeRF 360 cell's 3,112,960
    Gaussians, D = 6, k = 256, on a 1237x822 view (78 x 52 tiles) of
    ``gs360_frontend_inputs``: the forward (stream and inv over the live
    entries) bit for bit the plain version's, its stream the parent's
    composition's; the backward, from #16's stream gradient for a random d
    out, within 1e-6 relative Frobenius of the plain version and of
    autograd through the composition, in each attribute. Beside each, the
    parent's composition on the card (CUDA events, eager: the forward, or
    autograd's backward of it). Bytes, each read or written once: perm
    and the sorted tiles (12 B an entry), the attributes (40 B a
    Gaussian), the stream (64 B a column) and inv (4 B an entry) forward;
    inv (4 B an entry), ten 32 B sectors of the stream's gradient for each
    live entry and the gradients (40 B a Gaussian) backward."""
    from unittest import mock

    import torch

    from nerficg_torch.ops import gaussian as gsf
    from nerficg_torch.ops import gs_gather as gg
    from nerficg_torch.ops import gs_rasterize as gr
    from nerficg_torch.ops import gs_tiles_kernel as gtk
    from nerficg_torch.scripts.kernel_timing import events_ms
    n, (width, height), k = GS360_GAUSSIANS, GS360_VIEW, 256
    params, w2c, cam_pos, intrinsics = gs360_frontend_inputs(width, height,
                                                             3)
    inputs = gsf.gs_frontend_fwd(params, w2c, cam_pos, intrinsics, 4)
    del params
    seen = {}

    def capture(*args):
        seen['args'] = args
        return gg.stream_gather(*args)
    with mock.patch.object(gr, 'stream_gather', capture), torch.no_grad():
        s = gr.entry_stream(**inputs, width=width, height=height,
                            max_tiles_per_gaussian=6, max_per_tile=k)
    *attrs, perm, sorted_tile, starts, _, e_pad = seen['args']
    counts, num_tiles = s['counts'], s['num_tiles']
    e = perm.shape[0]
    live = int(torch.clamp(counts, max=k).sum())
    print(f'phase 2: entry gather at {width}x{height}: {n} Gaussians, '
          f'{e} entries, {int(counts.sum())} in {num_tiles} tiles, {live} '
          f'live (within k = {k}), E_pad {e_pad}', flush=True)

    fwd = (*attrs, perm, e_pad, sorted_tile, starts, k)
    got, inv = gg.gs_stream_gather(*fwd)
    want, inv_p = gg.gs_stream_gather_plain(*fwd)
    parent = _parent_stream(attrs, perm, e_pad)

    def same(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32)) and \
            torch.equal(a.view(torch.int32), parent.view(torch.int32)) and \
            torch.equal(inv, inv_p) and int((inv >= 0).sum()) == live
    lines = {'gs_stream_gather': dict(record(
        'gs_stream_gather', got, want, same,
        lambda: gg.gs_stream_gather(*fwd),
        lambda: gg.gs_stream_gather_plain(*fwd),
        f'{n} Gaussians x 6 -> the (16,{e_pad}) stream and inv',
        e * 8 + e * 4 + n * 40 + 16 * e_pad * 4 + e * 4, 0,
        plain_iters=5))}
    with torch.no_grad():
        lines['gs_stream_gather']['parent_ms'] = events_ms(
            lambda: _parent_stream(attrs, perm, e_pad), 5)
    del want, inv_p, parent

    out, tacc = gtk.gs_composite_fwd(got, starts, counts, s['tiles_x'],
                                     num_tiles, k)
    g = torch.Generator(device=out.device).manual_seed(4)
    dout = torch.randn(out.shape, generator=g, device=out.device)
    d_sorted = gtk.gs_composite_bwd(got, starts, counts, tacc, dout,
                                    s['tiles_x'], num_tiles, k)
    del got, out, tacc
    bwd = (d_sorted, inv, n)
    grads = gg.gs_stream_gather_bwd(*bwd)
    plain = gg.gs_stream_gather_bwd_plain(*bwd)
    leaves = [a.detach().clone().requires_grad_(True) for a in attrs]
    composed = _parent_stream(leaves, perm, e_pad)
    autograd = torch.autograd.grad(composed, leaves, d_sorted,
                                   retain_graph=True)

    def close(a, b):
        return all(float((x - y).norm()) <= 1e-6 * float(y.norm())
                   for ref in (plain, autograd)
                   for x, y in zip(grads, ref))
    lines['gs_stream_gather_bwd'] = dict(record(
        'gs_stream_gather_bwd', torch.cat([x.reshape(-1) for x in grads]),
        torch.cat([x.reshape(-1) for x in plain]), close,
        lambda: gg.gs_stream_gather_bwd(*bwd),
        lambda: gg.gs_stream_gather_bwd_plain(*bwd),
        f'd stream (16,{e_pad}), {live} live entries -> d attributes of '
        f'{n} Gaussians', e * 4 + live * 10 * 32 + n * 40, 0,
        plain_iters=3))
    lines['gs_stream_gather_bwd']['parent_ms'] = events_ms(
        lambda: torch.autograd.grad(composed, leaves, d_sorted,
                                    retain_graph=True), 3)
    print(f'phase 2: the parent\'s composition at the same shapes: '
          f'forward {lines["gs_stream_gather"]["parent_ms"]:.4f} ms, '
          f'autograd\'s backward '
          f'{lines["gs_stream_gather_bwd"]["parent_ms"]:.4f} ms (CUDA '
          f'events, eager)', flush=True)
    return lines


def record_gs_bwd(record, rng, args16, tacc, frame: str, counts):
    """#16 on one frame's 16-wide stream with its saved transmittance and a
    random d out, ``counts`` its ``gs_pairs``: checked and timed by
    ``record``; (d out, its line)."""
    import torch

    from nerficg_torch.ops import gs_tiles_kernel as gtk
    num_tiles = args16[4]
    pairs, passing = counts
    entries = pairs // gtk.P
    tacc_bytes = int(gtk.live_chunks(args16[2], 256).sum()) * gtk.P * 4
    out_bytes = num_tiles * gtk.OUT_ROWS * gtk.P * 4
    seg = (args16[1].numel() + args16[2].numel()) * 4    # starts, counts
    dout = torch.from_numpy(rng.normal(
        size=(num_tiles, gtk.OUT_ROWS, gtk.P)).astype('float32')).cuda()
    bwd = (*args16[:3], tacc, dout, *args16[3:])
    got = gtk.gs_composite_bwd(*bwd)
    # Gradients: the JAX package's own 2e-3 / 1e-3 (sums over 256 pixels in
    # another order than autograd's); two launches bit-equal (no atomics).
    line = record(
        'gs_composite_bwd', got,
        gtk.gs_composite_bwd_plain(*args16[:3], dout, *args16[3:]),
        lambda a, b: bool(torch.allclose(a, b, rtol=1e-3, atol=2e-3))
        and bool(torch.equal(a, gtk.gs_composite_bwd(*bwd))),
        lambda: gtk.gs_composite_bwd(*bwd),
        lambda: gtk.gs_composite_bwd_plain(*args16[:3], dout, *args16[3:]),
        f'{frame}: d out ({num_tiles},5,256) + tacc -> d stream '
        f'(16,{args16[0].shape[1]}), {entries} entries within k, {pairs} '
        f'pairs, {passing} passing',
        # d stream: the 10 attribute rows; rows 10-15 are the layout's
        # padding.
        entries * 10 * 4 + seg + tacc_bytes + out_bytes +
        10 * got.shape[1] * 4,
        GS_BWD_OPS * passing, sfu=passing, plain_iters=3)
    return dout, dict(line)


def record_gs_fwd(record, args16, frame: str, counts):
    """#15 on one frame's 16-wide stream, with its saved transmittance (on
    the chunks the tiles composite, the only ones the kernel writes and the
    backward reads), ``counts`` its ``gs_pairs``: checked and timed by
    ``record``; (tacc, its line)."""
    import torch

    from nerficg_torch.ops import gs_tiles_kernel as gtk
    num_tiles = args16[4]
    pairs, passing = counts
    live = gtk.live_chunks(args16[2], 256)
    seg = (args16[1].numel() + args16[2].numel()) * 4    # starts, counts
    out, tacc = gtk.gs_composite_fwd(*args16)
    out_p, tacc_p = gtk.gs_composite_fwd_plain(*args16)

    def close(a, b):
        return bool(torch.allclose(a, b, rtol=0.0, atol=1e-5))
    line = record(
        'gs_composite_fwd', out, out_p,
        lambda a, b: close(a, b) and close(tacc[live], tacc_p[live]),
        lambda: gtk.gs_composite_fwd(*args16),
        lambda: gtk.gs_composite_fwd_plain(*args16),
        f'{frame}: stream (16,{args16[0].shape[1]}) -> ({num_tiles},5,256) '
        f'+ tacc {tuple(tacc.shape)}, {int(live.sum())} chunks live',
        pairs // gtk.P * 10 * 4 + seg + num_tiles * gtk.OUT_ROWS * gtk.P * 4
        + int(live.sum()) * gtk.P * 4,
        GS_FWD_OPS * passing, sfu=passing, plain_iters=5)
    return tacc, dict(line)


def slot_windows(args16):
    """(slots (T, k, 10), counts (T,) int32, row-major origins (T, 2)) of a
    16-wide stream's tiles, as ``composite_tiles`` takes them."""
    from nerficg_torch.ops import gs_tiles_kernel as gtk
    sorted_mat, starts, counts, tiles_x, num_tiles, k = args16
    slots, _ = gtk._slots(sorted_mat, starts, tiles_x, k, 0, num_tiles)
    origins = gtk._tile_origins(num_tiles, tiles_x, sorted_mat.device)
    return slots.contiguous(), counts, origins


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


def profile_device(fn, label: str, card: str,
                   share_of: str | None = None) -> None:
    """torch.profiler over one warm call of ``fn``: wall time, the card's
    busy time (sum of kernel and memcpy/memset time), and the largest
    device-time entries by name; with ``share_of``, the time and share of
    the busy time of the kernels whose name holds it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()                                                   # warm-up
    torch.cuda.synchronize()
    # The card's activity only: the wall time is the host clock's, and
    # recording every host-side operation as well cost ~70 s of event
    # processing on a serving frame's 165,398 device operations.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    # Device events without the annotation ranges that span other kernels
    # (e.g. Optimizer.step), which would count their time twice.
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, 'is_user_annotation', False)]
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    if busy_ms <= 0.0:
        print(f'{label}: wall {wall_ms:.1f} ms; device time not measured '
              f'(the profiler recorded no kernels) [{card}]')
        return
    by_name: dict[str, list] = {}
    for e in events:
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += e.time_range.elapsed_us() / 1e3
        entry[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print(f'{label}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms '
          f'({100 * (1 - busy_ms / wall_ms):.1f}% idle), {len(events)} '
          f'device ops [{card}]')
    for name, (ms, count) in top:
        print(f'{label}:   {ms:9.3f} ms {count:6d}x  {name[:90]}')
    if share_of is not None:
        ms, count = (sum(v[i] for k, v in by_name.items()
                         if share_of.lower() in k.lower()) for i in (0, 1))
        print(f'{label}: kernels named *{share_of}*: {ms:.4f} ms over '
              f'{count} launches, {100 * ms / busy_ms:.2f}% of the busy '
              f'time [{card}]')


def profile_frame(run_dir: Path, card: str) -> None:
    """The profile of one warm frame of the serving path."""
    renderer, views = load_renderer(run_dir, 'cuda')
    profile_device(lambda: renderer.render_image(views[0], benchmark=True),
                   'phase 3: profile of one frame', card)


def phase3_main_path(card: str, image_size: int = 400,
                     repeats: int = 1) -> dict:
    """The port's inference entry point on the e2e config; returns the
    kernels' launch counts from that run."""
    import numpy as np
    import torch

    from nerficg_torch.ops.hash_mxu import seg_gather, seg_scatter_add
    from nerficg_torch.ops.hash_window import hash_window_fwd
    from nerficg_torch.ops.occupancy import block_probe_xyz
    from nerficg_torch.ops.xbar_gather import block_probe_cells, xbar_gather
    from nerficg_torch.scripts import inference

    wrappers = {'hash_window_fwd': hash_window_fwd,
                'block_probe_xyz': block_probe_xyz, 'seg_gather': seg_gather,
                'seg_scatter_add': seg_scatter_add,
                'block_probe': block_probe_cells, 'xbar_gather': xbar_gather}
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
        missing = [k for k, v in launches.items()
                   if v <= 0 and k not in ('block_probe', 'xbar_gather')]
        if missing:
            fail(f'kernels never launched on the main path: {missing}')
        probe_only(launches, 'phase 3')
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


def _training_wrappers() -> dict:
    """Every kernel wrapper of the three encode backends' paths."""
    from nerficg_torch.ops.hash_cell import hash_cell_bwd, hash_cell_fwd
    from nerficg_torch.ops.hash_mxu import seg_gather, seg_scatter_add
    from nerficg_torch.ops.hash_window import (hash_window_bwd,
                                               hash_window_bwd_cached,
                                               hash_window_fwd,
                                               hash_window_fwd_stoch)
    from nerficg_torch.ops.hash_xbar import (hash_xbar_bwd,
                                             hash_xbar_bwd_fused,
                                             hash_xbar_bwd_pos,
                                             hash_xbar_fwd)
    from nerficg_torch.ops.occupancy import block_probe_xyz
    from nerficg_torch.ops.xbar_gather import block_probe_cells, xbar_gather
    return {'hash_window_fwd': hash_window_fwd,
            'hash_window_fwd_stoch': hash_window_fwd_stoch,
            'hash_window_bwd': hash_window_bwd,
            'hash_window_bwd_cached': hash_window_bwd_cached,
            'hash_cell_fwd': hash_cell_fwd, 'hash_cell_bwd': hash_cell_bwd,
            'hash_xbar_fwd': hash_xbar_fwd, 'hash_xbar_bwd': hash_xbar_bwd,
            'hash_xbar_bwd_pos': hash_xbar_bwd_pos,
            'hash_xbar_bwd_fused': hash_xbar_bwd_fused,
            'block_probe_xyz': block_probe_xyz,
            'block_probe': block_probe_cells, 'xbar_gather': xbar_gather,
            'seg_gather': seg_gather, 'seg_scatter_add': seg_scatter_add}


PROBES = ('block_probe_xyz', 'block_probe', 'xbar_gather')


def probe_only(launches: dict, tag: str,
               probe: str = 'block_probe_xyz') -> None:
    """Fail unless the marcher probed through ``probe`` alone: the block
    probe from world planes (PROBE_MODE 'block'), never ``block_probe``
    (the op API's probe of integer cells), or, in PROBE_MODE 'dense',
    ``xbar_gather``."""
    counts = {k: launches[k] for k in PROBES}
    if counts[probe] <= 0 or any(v for k, v in counts.items()
                                 if k != probe):
        fail(f'{tag}: the marcher\'s probe launches {counts}; only {probe} '
             'should run')


def _small_training_config(scene: Path) -> dict:
    """The CPU one-step test's config (tests/test_torch_training.py): 6
    levels at 2^12, 32^3 grids, 2 cascades, exact corners, 256 rays."""
    return {'GLOBAL': {'METHOD_TYPE': 'InstantNGP', 'DATASET_TYPE': 'NeRF',
                       'RANDOM_SEED': 0, 'LOG_LEVEL': 'SILENT'},
            'DATASET': {'PATH': str(scene)},
            'MODEL': {'NUM_LEVELS': 6, 'LOG2_HASHMAP_SIZE': 12,
                      'BASE_RESOLUTION': 4, 'TARGET_RESOLUTION': 256,
                      'GRID_RESOLUTION': 32, 'SCALE': 1.0,
                      'STOCHASTIC_CORNERS': 0},
            'RENDERER': {'MAX_SAMPLES': 64, 'RAY_BATCH_SIZE': 1024},
            'TRAINING': {'INITIAL_RAYS_PER_BATCH': 256,
                         'TARGET_BATCH_SIZE': 8192}}


def phase4_training_step(card: str, card_device: str = 'cuda') -> dict:
    """One exact-corner training step through the trainer's own code on the
    card (CUDA kernels) and on the CPU (plain versions), same weights, grid,
    rays, background and march seed. Tolerances of the CPU one-step test:
    loss 1e-5 relative; per parameter, gradient norm 1e-3 relative and
    relative Frobenius error 2e-2 (the bf16 noise floor, see
    tests/test_torch_training.py). Returns hash_window_bwd's launches."""
    import numpy as np
    import torch

    from nerficg_torch.core.config import ConfigNode
    from nerficg_torch.core.logging import Logger
    from nerficg_torch.core.registry import Datasets, Methods
    from nerficg_torch.data.synthetic import make_textured_scene
    from nerficg_torch.methods.instant_ngp.convert import params_to_numpy

    wrappers = _training_wrappers()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_step_') as tmp:
        scene = make_textured_scene(Path(tmp) / 'scene', image_size=32,
                                    n_train=8, n_test=1)
        config = ConfigNode(_small_training_config(scene))
        Logger.set_level('SILENT')
        rng = np.random.default_rng(0)
        trainers, tree = {}, None
        for role, device in (('card', card_device), ('cpu', 'cpu')):
            trainer = Methods.get_training_instance(config, device=device)
            if tree is None:
                shapes = trainer.model.params_tree()

                def he_uniform(w):
                    bound = np.sqrt(6.0 / w.shape[0])
                    return rng.uniform(-bound, bound, w.shape).astype(
                        np.float32)
                tree = {'hash_table': rng.uniform(
                            -0.1, 0.1, shapes['hash_table'].shape).astype(
                            np.float32),
                        'density_mlp': [he_uniform(w)
                                        for w in shapes['density_mlp']],
                        'color_mlp': [he_uniform(w)
                                      for w in shapes['color_mlp']]}
            trainer.model.load_params_tree(tree)
            trainer.model.buffers['density_grid'] = torch.as_tensor(
                shell_density_grid(32, 2, 1.0, thickness_cells=6.0),
                device=device)
            trainer._init_samplers(Datasets.get_dataset(config))
            trainers[role] = trainer
        Logger.set_level('NORMAL')
        ids = rng.integers(0, trainers['cpu']._pool_size, 256)
        bg = rng.random(3).astype(np.float32)
        logs, grads = {}, {}
        for role, trainer in trainers.items():
            device = trainer.device
            if role == 'card':
                torch.cuda.synchronize()
                for fn in wrappers.values():
                    fn.launches = 0
            logs[role] = trainer.loss_and_grads(
                torch.as_tensor(ids, device=device),
                torch.as_tensor(bg, device=device), 0x2545F491, 0)
            if role == 'card':
                torch.cuda.synchronize()
                launches = {k: fn.launches for k, fn in wrappers.items()}
            grads[role] = params_to_numpy(
                {k: p.grad for k, p in trainer.model.module.named_parameters()})
    print(f'phase 4: kernel launches in the exact training step: {launches}')
    if launches['hash_window_bwd'] <= 0:
        fail('the exact training step never launched hash_window_bwd')
    probe_only(launches, 'phase 4')
    loss_gpu, loss_cpu = (float(logs[d]['total']) for d in ('card', 'cpu'))
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    print(f'phase 4: loss card {loss_gpu:.8f}, CPU {loss_cpu:.8f}, relative '
          f'error {loss_err:.2e} (limit 1e-5); '
          f'{int(logs["card"]["num_samples"])} samples [{card}]')
    worst = []
    for name in ('hash_table', 'density_mlp', 'color_mlp'):
        pairs = zip(*(grads[d][name] if name != 'hash_table'
                      else [grads[d][name]] for d in ('card', 'cpu')))
        for i, (g, c) in enumerate(pairs):
            norm = max(float(np.linalg.norm(c)), 1e-30)
            frob = float(np.linalg.norm(g - c)) / norm
            norm_err = abs(float(np.linalg.norm(g)) - norm) / norm
            worst.append((frob, norm_err, f'{name}[{i}]'))
            print(f'phase 4: gradient {name}[{i}]: relative Frobenius '
                  f'{frob:.2e} (limit 2e-2), norm {norm_err:.2e} (limit 1e-3)')
    if not loss_err <= 1e-5:
        fail(f'training step loss: card and CPU differ by {loss_err:.2e}')
    bad = [w for w in worst if not (w[0] <= 2e-2 and w[1] <= 1e-3)]
    if bad:
        fail(f'training step gradients: card and CPU disagree: {bad}')
    return {'hash_window_bwd': launches['hash_window_bwd']}


# The sample count of each launch of the windowed and crossbar forwards
# (#1 exact, #8, #10) on the main paths: kernel -> run -> counts.
FWD_SIZES: dict = {}


@contextlib.contextmanager
def fwd_sizes(label: str):
    """Record under ``label`` the sample count of every exact window (#1),
    cell (#8) and crossbar (#10) forward launched inside the block, by
    wrapping each wrapper's launcher; the launch counts are the wrappers',
    untouched."""
    from nerficg_torch.ops import hash_cell as hc
    from nerficg_torch.ops import hash_window as hw
    from nerficg_torch.ops import hash_xbar as hx
    launchers = {'#1': hw, '#8': hc, '#10': hx}
    originals = {kernel: mod._launch_fwd for kernel, mod in launchers.items()}

    def recording(kernel):
        sizes = FWD_SIZES.setdefault(kernel, {}).setdefault(label, [])
        launch = originals[kernel]

        def record(name, table, positions, *args, **kwargs):
            sizes.append(int(positions.shape[0]))
            return launch(name, table, positions, *args, **kwargs)
        return record
    for kernel, mod in launchers.items():
        mod._launch_fwd = recording(kernel)
    try:
        yield
    finally:
        for kernel, mod in launchers.items():
            mod._launch_fwd = originals[kernel]


@contextlib.contextmanager
def seg_scatter_shapes():
    """Record the (F, M, rows) of every segment scatter-add (#7) launched
    inside the block, by wrapping the wrapper's plan lookup; the launch
    counts are the wrapper's, untouched."""
    from nerficg_torch.ops import hash_mxu as hm
    shapes = collections.Counter()
    lookup = hm._scatter_plan

    def recording(feats, m, rows):
        shapes[feats, m, rows] += 1
        return lookup(feats, m, rows)
    hm._scatter_plan = recording
    try:
        yield shapes
    finally:
        hm._scatter_plan = lookup


def print_seg_scatter_shapes(shapes) -> None:
    """#7's calls by their planes' shared memory: how many, the largest
    (F, M, rows) and the path each plan took."""
    from nerficg_torch.ops.hash_mxu import seg_scatter_plan
    if not shapes:
        fail('no segment scatter-add was launched in phases 3-11 and 15')
    paths = collections.Counter()
    for (feats, m, rows), count in shapes.items():
        paths[seg_scatter_plan(feats, m, rows)] += count
    feats, m, rows = max(shapes, key=lambda k: k[0] * k[2])
    print(f'#7 calls, phases 3-11 and 15: {sum(shapes.values())} launches '
          f'of {len(shapes)} shapes, by path {dict(paths)}; largest planes '
          f'F = {feats}, M = {m}, rows = {rows} ({feats * rows * 512} bytes, '
          f'{seg_scatter_plan(feats, m, rows)})', flush=True)


def print_fwd_sizes() -> None:
    """The distribution of each forward's sample counts over each recorded
    run: launches, min, median, max, the commonest; for #10 also how many
    fell under the plan's FWD_MIN_SAMPLES (the gather path at 2^14
    entries)."""
    import numpy as np

    from nerficg_torch.ops.hash_xbar import FWD_MIN_SAMPLES
    for kernel, runs in FWD_SIZES.items():
        for label, sizes in runs.items():
            if not sizes:
                continue
            a = np.array(sizes)
            common = collections.Counter(sizes).most_common(4)
            under = (f'; {int((a < FWD_MIN_SAMPLES).sum())} under '
                     f'FWD_MIN_SAMPLES {FWD_MIN_SAMPLES}'
                     if kernel == '#10' else '')
            print(f'{kernel} sample counts, {label}: {a.size} launches, '
                  f'min {a.min()}, median {int(np.median(a))}, max '
                  f'{a.max()}{under}; commonest (N, launches) {common}',
                  flush=True)


def _launches_of(run, wrappers: dict) -> tuple:
    """Run ``run()`` with every wrapper's count set to 0 just before and
    read just after; returns (its result, the counts)."""
    import torch
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    result = run()
    torch.cuda.synchronize()
    return result, {k: fn.launches for k, fn in wrappers.items()}


def _work_dir(work: Path | None, prefix: str):
    """``work`` as a context (kept), or a new temporary directory."""
    if work is not None:
        work.mkdir(parents=True, exist_ok=True)
        return contextlib.nullcontext(work)
    return tempfile.TemporaryDirectory(prefix=prefix)


def phase_training(card: str, phase: int | str, scene: Path, config: str,
                   overrides: tuple, trained: tuple, served: tuple = (),
                   iterations: int = 200, fps: bool = True,
                   profile_share: str | None = None,
                   probe: str = 'block_probe_xyz',
                   work: Path | None = None,
                   psnr_before: float | None = None) -> dict:
    """The port's training entry point on ``config`` with ``overrides`` for
    ``iterations`` iterations on the 400x400 textured ``scene``, after an
    untrained run (0 iterations: carving and the warm-up grid) for the
    baseline PSNR, then, if ``served`` names kernels, its inference entry
    point on the run directory. Checks that the kernels ``trained`` (and
    ``served``) launched in those runs, that the loss fell, that the test
    PSNR rose by at least 5 dB over the untrained model's, in the trainer's
    test render and in the served one, and that the served metrics are
    finite, and that the marcher probed through ``probe`` alone
    (``probe_only``); profiles one warm training step (with
    ``profile_share``, the share of its busy time in the kernels so
    named). ``psnr_before``: the untrained model's PSNR of an earlier phase
    whose untrained model is the same (the same weights, grid and test
    render), instead of an untrained run. ``fps``: serve with ``-b
    --repeats 1`` (the FPS benchmark: a warm-up render and one more pass
    over the test set), else only ``-m``. Returns the launch counts of the
    kernels it checks, training and serving runs summed, and the trained
    model's test PSNR ('test_psnr'). The run directories go under ``work``
    when it is given (and stay), else under a temporary directory."""
    import numpy as np
    import torch

    from nerficg_torch.core.setup import Directories
    from nerficg_torch.scripts import inference, train

    tag = f'phase {phase}'
    wrappers = _training_wrappers()
    with _work_dir(work, 'chip_smoke_train_') as tmp:
        Directories.base = Path(tmp) / 'output'
        args = ['-c', str(ROOT / 'configs' / config), f'DATASET.PATH={scene}',
                'TRAINING.RENDER_TESTSET=True', *overrides]
        shown = ' '.join(args[1:2] + list(overrides))
        if psnr_before is None:
            before = train.main(args + ['TRAINING.NUM_ITERATIONS=0',
                                        'TRAINING.MODEL_NAME=untrained'])
            psnr_before = float(before['metrics']['PSNR'])
            print(f'{tag}: untrained model (carved, warm-up grid): test '
                  f'PSNR {psnr_before:.3f} dB [{card}]', flush=True)
        else:
            print(f'{tag}: untrained model: test PSNR {psnr_before:.3f} dB, '
                  f'phase 5\'s (the same weights, grid and test render)',
                  flush=True)

        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        result, launches = _launches_of(lambda: train.main(
            args + [f'TRAINING.NUM_ITERATIONS={iterations}',
                    'TRAINING.MODEL_NAME=chip_smoke']), wrappers)
        wall = time.perf_counter() - start
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        trainer = result['trainer']
        losses = torch.stack(trainer.losses).float().cpu().numpy()
        psnr = float(result['metrics']['PSNR'])
        timers = trainer.timers
        loop = [timers[k] for k in ('training_iteration', '_update_occupancy',
                                    '_resize_batch', '_log_progress')
                if k in timers]
        loop_s = sum(t.total for t in loop)
        step = timers['training_iteration']
        print(f'{tag}: train.main {shown} TRAINING.NUM_ITERATIONS='
              f'{iterations}: whole run {wall:.1f} s, training loop '
              f'{loop_s:.2f} s = {iterations / loop_s:.2f} it/s, '
              f'{step.mean * 1e3:.2f} ms per training_iteration, final '
              f'rays/batch {trainer.rays_per_batch} [{card}]')
        for line in (Path(result['output_dir']) / 'timings.txt'
                     ).read_text().splitlines():
            print(f'{tag}: timings.txt: {line}')
        print(f'{tag}: peak torch.cuda.max_memory_allocated of the training '
              f'run {peak:.1f} MiB [{card}]')
        print(f'{tag}: loss mean of iterations 0-49 {losses[:50].mean():.6f}'
              f', of the last 50 {losses[-50:].mean():.6f}')
        print(f'{tag}: test metrics after {iterations} iterations: ' +
              ', '.join(f'{k}={v:.4f}' for k, v in result['metrics'].items())
              + f' (untrained {psnr_before:.3f} dB) [{card}]')
        print(f'{tag}: kernel launches in the training run: '
              f'{ {k: launches[k] for k in trained} }', flush=True)
        missing = [k for k in trained if launches[k] <= 0]
        if missing:
            fail(f'{tag}: kernels never launched while training: {missing}')
        probe_only(launches, f'{tag} training', probe)
        if len(losses) != iterations or not np.isfinite(losses).all():
            fail(f'{tag}: training loss is missing or not finite')
        if not losses[-50:].mean() < losses[:50].mean():
            fail(f'{tag}: the training loss did not fall')
        if not (np.isfinite(psnr) and psnr >= psnr_before + 5.0):
            fail(f'{tag}: test PSNR {psnr:.3f} dB is not 5 dB above the '
                 f'untrained model\'s {psnr_before:.3f} dB')
        profile_device(lambda: trainer.training_iteration(None, iterations),
                       f'{tag}: profile of one training step', card,
                       profile_share)
        counts = {k: launches[k] for k in trained}
        counts['test_psnr'] = psnr
        counts['untrained_psnr'] = psnr_before
        if not served:
            return counts

        run_dir = Path(result['output_dir'])
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        flags = ['-m', '-b', '--repeats', '1'] if fps else ['-m']
        served_result, launches = _launches_of(lambda: inference.main(
            ['-d', str(run_dir), '-s', 'test', *flags]), wrappers)
        wall = time.perf_counter() - start
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        metrics = served_result['metrics']['test']
        served_fps = served_result['fps'] if fps else 0.0
        print(f'{tag}: inference -d RUN -s test {" ".join(flags)}: '
              + (f'{served_fps:.3f} FPS at 400x400, ' if fps else '')
              + f'whole run {wall:.1f} s, peak '
              f'torch.cuda.max_memory_allocated {peak:.1f} MiB [{card}]')
        print(f'{tag}: served test metrics: ' + ', '.join(
            f'{k}={v:.4f}' for k, v in metrics.items()) + f' [{card}]')
        print(f'{tag}: kernel launches in the serving run: '
              f'{ {k: launches[k] for k in served} }', flush=True)
        missing = [k for k in served if launches[k] <= 0]
        if missing:
            fail(f'{tag}: kernels never launched while serving: {missing}')
        probe_only(launches, f'{tag} serving', probe)
        if not all(np.isfinite(v) for v in (metrics['PSNR'], metrics['SSIM'],
                                              served_fps)):
            fail(f'{tag}: non-finite served metrics or FPS: {metrics}')
        if not float(metrics['PSNR']) >= psnr_before + 5.0:
            fail(f'{tag}: the served test PSNR {metrics["PSNR"]:.3f} dB is '
                 f'not 5 dB above the untrained model\'s {psnr_before:.3f} dB')
        for name in served:
            counts[name] = counts.get(name, 0) + launches[name]
        return counts


def _gs_wrappers() -> dict:
    from nerficg_torch.ops.gaussian import gs_frontend_bwd, gs_frontend_fwd
    from nerficg_torch.ops.gs_gather import (gs_stream_gather,
                                             gs_stream_gather_bwd)
    from nerficg_torch.ops.gs_tiles_kernel import (gs_composite_bwd,
                                                   gs_composite_fwd,
                                                   gs_composite_fwd_packed)
    return {'gs_composite_fwd': gs_composite_fwd,
            'gs_composite_fwd_packed': gs_composite_fwd_packed,
            'gs_composite_bwd': gs_composite_bwd,
            'gs_frontend_fwd': gs_frontend_fwd,
            'gs_frontend_bwd': gs_frontend_bwd,
            'gs_stream_gather': gs_stream_gather,
            'gs_stream_gather_bwd': gs_stream_gather_bwd}


def check_frontend_launches(tag: str, launches: dict) -> None:
    """Every rasterization (#15, 16-wide or packed) ran the frontend's
    forward kernel once, and every backward (#16) its backward kernel
    once; every 16-wide one the entry gather's forward kernel once, and
    every backward its backward kernel once."""
    composites = launches['gs_composite_fwd'] + \
        launches['gs_composite_fwd_packed']
    if launches['gs_frontend_fwd'] != composites or \
            launches['gs_frontend_bwd'] != launches['gs_composite_bwd']:
        fail(f'{tag}: the frontend kernels launched '
             f'{launches["gs_frontend_fwd"]} and '
             f'{launches["gs_frontend_bwd"]} times for {composites} '
             f'composites and {launches["gs_composite_bwd"]} backwards')
    if launches['gs_stream_gather'] != launches['gs_composite_fwd'] or \
            launches['gs_stream_gather_bwd'] != launches['gs_composite_bwd']:
        fail(f'{tag}: the entry gather kernels launched '
             f'{launches["gs_stream_gather"]} and '
             f'{launches["gs_stream_gather_bwd"]} times for '
             f'{launches["gs_composite_fwd"]} 16-wide composites and '
             f'{launches["gs_composite_bwd"]} backwards')


def _gs_config_path() -> Path:
    return ROOT / 'nerficg_torch' / 'configs' / 'gaussian_splatting.yaml'


def _psnr_db(a, b) -> float:
    import numpy as np
    mse = float(((a - b) ** 2).mean())
    return -10.0 * float(np.log10(max(mse, 1e-20)))


def phase8_gs_serving(card: str, scene: Path) -> dict:
    """3DGS serving at full width: bench.py's 100k-Gaussian model with all
    four SH bands active (the higher bands N(0, 0.1) from numpy seed 1, so
    that they change the colors) as a checkpoint, served on the textured
    scene's test views through the inference entry point; then bench.py's
    protocol through ``render_image`` and the card against the CPU.
    Returns the packed compositor's launches in the inference run."""
    import numpy as np
    import torch

    from nerficg_torch.core.config import load_config, save_config
    from nerficg_torch.scripts import inference
    from nerficg_torch.scripts.kernel_timing import gs_model, orbit_view

    with tempfile.TemporaryDirectory(prefix='chip_smoke_gs_') as tmp:
        run_dir = Path(tmp) / 'run'
        config = load_config(_gs_config_path())
        config.DATASET.PATH = str(scene)
        save_config(config, run_dir / 'training_config.yaml')
        start = time.perf_counter()
        model = gs_model('cuda')
        rest = np.random.default_rng(1).normal(
            size=tuple(model.params['features_rest'].shape)) * 0.1
        with torch.no_grad():
            model.params['features_rest'].copy_(torch.as_tensor(rest))
        model.active_sh_degree = int(model.SH_DEGREE)
        model.save(run_dir / 'checkpoints' / 'final.ckpt')
        print(f'phase 8: 3DGS checkpoint ({model.num_active} Gaussians in '
              f'{model.capacity} slots, SH degree {model.active_sh_degree}) '
              f'written in {time.perf_counter() - start:.1f} s', flush=True)
        wrappers = _gs_wrappers()
        torch.cuda.reset_peak_memory_stats()
        result, launches = _launches_of(lambda: inference.main(
            ['-d', str(run_dir), '-s', 'test', '-m', '-b', '--repeats', '1']),
            wrappers)
        metrics = result['metrics']['test']
        print(f'phase 8: inference -s test -m -b --repeats 1: '
              f'{result["fps"]:.3f} FPS at 400x400, test metrics (random '
              f'Gaussians, so only finiteness matters): ' + ', '.join(
                  f'{k}={v:.4f}' for k, v in metrics.items()) +
              f', peak torch.cuda.max_memory_allocated '
              f'{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB '
              f'[{card}]')
        print(f'phase 8: kernel launches in that run: {launches}', flush=True)
        if launches['gs_composite_fwd_packed'] <= 0:
            fail('phase 8: gs_composite_fwd_packed never launched')
        check_frontend_launches('phase 8', launches)
        if not all(np.isfinite(v) for v in (metrics['PSNR'], metrics['SSIM'],
                                              result['fps'])):
            fail(f'phase 8: non-finite served metrics: {metrics}')

        # bench.py's protocol: 1920x1080, focal 0.8 w, 8 orbit poses at
        # radius 3, 64 frames after a warm-up of each pose, timed to the
        # last device sync.
        renderer, _ = load_renderer(run_dir, 'cuda')
        views = [orbit_view(2 * np.pi * i / 8, 1920, 1080) for i in range(8)]
        for view in views:
            renderer.render_image(view)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for i in range(64):
            out = renderer.render_image(views[i % 8])
        torch.cuda.synchronize()
        fps = 64 / (time.perf_counter() - start)
        with torch.no_grad():
            intrinsics, w2c, cam_pos = renderer.view_constants(views[0])
            probe = renderer.render_impl(
                model.params, torch.zeros((model.capacity, 2), device='cuda'),
                w2c, cam_pos, intrinsics, torch.zeros(3, device='cuda'),
                model.active_sh_degree, packed_inference=True)
        print(f'phase 8: 3DGS 1920x1080, 64 frames over 8 orbit poses: '
              f'{fps:.2f} FPS; pose 0: {int(probe["counts"].sum())} stream '
              f'entries, overflow_gaussians '
              f'{int(probe["overflow_gaussians"])}, overflow_entries '
              f'{int(probe["overflow_entries"])} [{card}]', flush=True)
        if out['rgb'].shape != (1080, 1920, 3) or not all(
                bool(torch.isfinite(v).all()) for v in out.values()):
            fail('phase 8: 1080p frames have the wrong shape or non-finite '
                 'values')
        profile_device(lambda: renderer.render_image(views[0],
                                                     benchmark=True),
                       'phase 8: profile of one 1080p frame', card)
        # The card against the CPU plain versions on a small frame.
        cpu_renderer, _ = load_renderer(run_dir, 'cpu')
        small = orbit_view(0.0, 192, 108)
        gpu = {k: v.cpu() for k, v in renderer.render_image(small).items()}
        cpu = cpu_renderer.render_image(small)
        for key in ('rgb', 'alpha'):
            db = _psnr_db(gpu[key], cpu[key])
            print(f'phase 8: 192x108 {key}, CUDA kernels vs CPU plain '
                  f'versions: PSNR {db:.1f} dB (limit 45)')
            if db < 45.0:
                fail(f'phase 8: card and CPU renders disagree on {key}: '
                     f'{db:.1f} dB')
    return launches


def phase9_gs_training(card: str, scene: Path,
                       iterations: int = 3500) -> dict:
    """The GS config through the training entry point on the 400x400
    textured scene for ``iterations`` of its 30,000 iterations, after an
    untrained run (0 iterations: the random init) for the baseline PSNR;
    then a profile of one warm step and the run served through the
    inference entry point. 3500 (4500 until phase 20 came) and not far
    fewer: the random init fills the cameras' whole box, and its floaters
    go only at the first opacity reset (iteration 3000); on an H100, 1200
    iterations raised the test PSNR by 1.0 dB, 4000 by 6.8, 4500 by 7.1
    and 6000 by 8.4. Returns the GS kernels' launch counts
    of the training run (forward and backward) and the serving run
    (packed)."""
    import numpy as np
    import torch

    from nerficg_torch.core.registry import Datasets
    from nerficg_torch.core.setup import Directories
    from nerficg_torch.scripts import inference, train

    wrappers = _gs_wrappers()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_gs_train_') as tmp:
        Directories.base = Path(tmp) / 'output'
        args = ['-c', str(_gs_config_path()), f'DATASET.PATH={scene}',
                'TRAINING.RENDER_TESTSET=True']
        before = train.main(args + ['TRAINING.NUM_ITERATIONS=0',
                                    'TRAINING.MODEL_NAME=untrained'])
        psnr_before = float(before['metrics']['PSNR'])
        print(f'phase 9: untrained 3DGS (100k random points in the box): '
              f'test PSNR {psnr_before:.3f} dB [{card}]', flush=True)
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        result, launches = _launches_of(lambda: train.main(
            args + [f'TRAINING.NUM_ITERATIONS={iterations}',
                    'TRAINING.MODEL_NAME=chip_smoke']), wrappers)
        wall = time.perf_counter() - start
        trainer = result['trainer']
        losses = torch.stack(trainer.losses).float().cpu().numpy()
        psnr = float(result['metrics']['PSNR'])
        step = trainer.timers['training_iteration']
        loop_s = sum(t.total for name, t in trainer.timers.items()
                     if name in ('training_iteration', '_densify',
                                 '_reset_opacity', '_increase_sh_degree',
                                 '_log_progress'))
        print(f'phase 9: train.main gaussian_splatting.yaml '
              f'TRAINING.NUM_ITERATIONS={iterations}: whole run {wall:.1f} s,'
              f' training loop {loop_s:.2f} s = {iterations / loop_s:.2f} '
              f'it/s, {step.mean * 1e3:.2f} ms per training_iteration, '
              f'{trainer.model.num_active} Gaussians after the bake '
              f'(100000 at init) [{card}]')
        for line in (Path(result['output_dir']) / 'timings.txt'
                     ).read_text().splitlines():
            print(f'phase 9: timings.txt: {line}')
        print(f'phase 9: peak torch.cuda.max_memory_allocated of the training '
              f'run {torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB '
              f'[{card}]')
        print(f'phase 9: loss mean of iterations 0-49 {losses[:50].mean():.6f}'
              f', of the last 50 {losses[-50:].mean():.6f}')
        print(f'phase 9: test metrics after {iterations} iterations: ' +
              ', '.join(f'{k}={v:.4f}' for k, v in result['metrics'].items())
              + f' (untrained {psnr_before:.3f} dB) [{card}]')
        print(f'phase 9: kernel launches in the training run: {launches}',
              flush=True)
        for name in ('gs_composite_fwd', 'gs_composite_bwd'):
            if launches[name] != iterations:
                fail(f'phase 9: {name} launched {launches[name]} times in '
                     f'{iterations} iterations')
        check_frontend_launches('phase 9', launches)
        if len(losses) != iterations or not np.isfinite(losses).all():
            fail('phase 9: training loss is missing or not finite')
        if not losses[-50:].mean() < losses[:50].mean():
            fail('phase 9: the training loss did not fall')
        if trainer.model.num_active == 100_000:
            fail('phase 9: the Gaussian count never changed')
        if not (np.isfinite(psnr) and psnr >= psnr_before + 5.0):
            fail(f'phase 9: test PSNR {psnr:.3f} dB is not 5 dB above the '
                 f'untrained model\'s {psnr_before:.3f} dB')
        # One warm step on the baked model, with a fresh optimizer.
        trainer._build_optimizer()
        trainer._reset_densify_stats()
        dataset = Datasets.get_dataset(trainer._config)
        profile_device(lambda: trainer.training_iteration(dataset,
                                                          iterations),
                       'phase 9: profile of one training step', card)

        served, served_launches = _launches_of(lambda: inference.main(
            ['-d', str(result['output_dir']), '-s', 'test', '-m', '-b',
             '--repeats', '1']), wrappers)
        metrics = served['metrics']['test']
        print(f'phase 9: inference -d RUN -s test -m -b --repeats 1: '
              f'{served["fps"]:.3f} FPS at 400x400, served test metrics: ' +
              ', '.join(f'{k}={v:.4f}' for k, v in metrics.items()) +
              f'; launches {served_launches} [{card}]', flush=True)
        if served_launches['gs_composite_fwd_packed'] <= 0:
            fail('phase 9: serving never launched gs_composite_fwd_packed')
        check_frontend_launches('phase 9 (serving)', served_launches)
        if not float(metrics['PSNR']) >= psnr_before + 5.0:
            fail(f'phase 9: the served test PSNR {metrics["PSNR"]:.3f} dB is '
                 f'not 5 dB above the untrained model\'s '
                 f'{psnr_before:.3f} dB')
    return {'gs_composite_fwd': launches['gs_composite_fwd'],
            'gs_composite_bwd': launches['gs_composite_bwd'],
            'gs_composite_fwd_packed':
                served_launches['gs_composite_fwd_packed'],
            'gs_frontend_fwd': launches['gs_frontend_fwd'] +
                served_launches['gs_frontend_fwd'],
            'gs_frontend_bwd': launches['gs_frontend_bwd'],
            'gs_stream_gather': launches['gs_stream_gather'] +
                served_launches['gs_stream_gather'],
            'gs_stream_gather_bwd': launches['gs_stream_gather_bwd']}


def _rel_frobenius(got, want) -> float:
    import numpy as np
    return float(np.linalg.norm(got - want) /
                 max(float(np.linalg.norm(want)), 1e-30))


def phase10_gs_step(card: str) -> None:
    """One GS training step at a small width (4000 random points in the
    box of a 128x128 textured scene, SH degree 1) through the trainer's own
    code on the card and on the CPU, from the same init and view. Loss
    within 1e-5 relative; the six parameter gradients and the viewspace
    gradient norm within 1e-3 relative Frobenius (sums in another order:
    the kernel's pixel sums, cuBLAS's small products)."""
    import torch

    from nerficg_torch.core.config import ConfigNode
    from nerficg_torch.core.logging import Logger
    from nerficg_torch.core.registry import Datasets, Methods
    from nerficg_torch.data.synthetic import make_textured_scene

    with tempfile.TemporaryDirectory(prefix='chip_smoke_gs_step_') as tmp:
        scene = make_textured_scene(Path(tmp) / 'scene', image_size=128,
                                    n_train=4, n_test=1)
        config = ConfigNode({
            'GLOBAL': {'METHOD_TYPE': 'GaussianSplatting',
                       'DATASET_TYPE': 'NeRF', 'RANDOM_SEED': 0,
                       'LOG_LEVEL': 'SILENT'},
            'DATASET': {'PATH': str(scene)},
            'TRAINING': {'RANDOM_POINTS': 4000}})
        Logger.set_level('SILENT')
        results = {}
        for role, device in (('card', 'cuda'), ('cpu', 'cpu')):
            trainer = Methods.get_training_instance(config, device=device)
            dataset = Datasets.get_dataset(config)
            trainer._setup_gaussians(dataset)
            view = dataset.subsets['train'][1]
            intrinsics, w2c, cam_pos = trainer.renderer.view_constants(view)
            background = torch.zeros(3, device=device)

            def step():
                return trainer.loss_and_grads(w2c, cam_pos, intrinsics,
                                              background,
                                              trainer._target(1, view))
            if role == 'card':
                logs, launches = _launches_of(step, _gs_wrappers())
            else:
                logs = step()
            results[role] = (
                float(logs['total']),
                {k: p.grad.cpu().numpy()
                 for k, p in trainer.model.params.items()},
                logs['viewspace_grad_norm'].cpu().numpy())
        Logger.set_level('NORMAL')
    (loss_g, grads_g, vs_g), (loss_c, grads_c, vs_c) = \
        results['card'], results['cpu']
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    print(f'phase 10: 3DGS step at 128x128 (4000 Gaussians): loss card '
          f'{loss_g:.8f}, CPU {loss_c:.8f}, relative error {loss_err:.2e} '
          f'(limit 1e-5); launches {launches} [{card}]')
    errors = {k: _rel_frobenius(grads_g[k], grads_c[k]) for k in grads_c}
    errors['viewspace_grad_norm'] = _rel_frobenius(vs_g, vs_c)
    for name, err in errors.items():
        print(f'phase 10: {name}: relative Frobenius {err:.2e} (limit 1e-3)')
    if launches['gs_composite_fwd'] != 1 or launches['gs_composite_bwd'] != 1:
        fail(f'phase 10: the step did not launch #15 and #16 once each: '
             f'{launches}')
    check_frontend_launches('phase 10', launches)
    if not loss_err <= 1e-5:
        fail(f'phase 10: card and CPU losses differ by {loss_err:.2e}')
    bad = {k: v for k, v in errors.items() if not v <= 1e-3}
    if bad:
        fail(f'phase 10: card and CPU gradients disagree: {bad}')


def _dnerf_config_path() -> Path:
    return ROOT / 'nerficg_torch' / 'configs' / 'dnerf.yaml'


# D-NeRF's iterations in phase 11 (and its static control's): 300 of the
# config's 30,000, for the time limit (2000 until phase 17 came, 1000
# until phase 19 came, 500 until phase 20 came; on an H100 2000 raised the
# test PSNR from 12.2 to 23.8 dB, 1000 to 23.2, 500 to 21.9 and 400 to
# 20.9, above the +5 dB checked, and 2000 moved the deformation's offsets
# by up to 0.68).
DNERF_ITERATIONS = 300


def phase11_dnerf(card: str, scene: Path,
                  iterations: int = DNERF_ITERATIONS) -> dict:
    """D-NeRF: nerficg_torch/configs/dnerf.yaml through the training entry
    point on the 400x400 dynamic scene for ``iterations`` of its 30,000
    (which also compresses the deformation rate's decay, tied to
    NUM_ITERATIONS, into the cut), after an untrained run for the baseline
    PSNR. Checks that the fused crossbar backward (#11 and #12 in one
    launch) ran once per iteration, the loss fell, the deformation's output
    layer left zero and moves points differently at t = 1/4 and 3/4, and
    the test PSNR, trained and served through the inference entry point, is
    at least 5 dB above the untrained model's. Prints, without a check, the
    static control: Instant-NGP with the same config (crossbar, exact
    corners) on the same scene and iterations, and its launches. Returns
    the crossbar kernels' launch counts: the fused entry's of the training
    run, #10's and #11's of all three runs (D-NeRF trained and served, the
    control trained) summed."""
    import numpy as np
    import torch

    from nerficg_torch.core.setup import Directories
    from nerficg_torch.scripts import inference, train

    wrappers = _training_wrappers()
    tag = 'phase 11'
    with tempfile.TemporaryDirectory(prefix='chip_smoke_dnerf_') as tmp:
        Directories.base = Path(tmp) / 'output'
        args = ['-c', str(_dnerf_config_path()), f'DATASET.PATH={scene}']
        before = train.main(args + ['TRAINING.NUM_ITERATIONS=0',
                                    'TRAINING.MODEL_NAME=untrained'])
        psnr_before = float(before['metrics']['PSNR'])
        print(f'{tag}: untrained D-NeRF (carved, warm-up grid): test PSNR '
              f'{psnr_before:.3f} dB [{card}]', flush=True)
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        with fwd_sizes('phase 11 D-NeRF training (grid refreshes '
                            'included)'):
            result, launches = _launches_of(lambda: train.main(
                args + [f'TRAINING.NUM_ITERATIONS={iterations}',
                        'TRAINING.MODEL_NAME=chip_smoke']), wrappers)
        wall = time.perf_counter() - start
        trainer = result['trainer']
        losses = torch.stack(trainer.losses).float().cpu().numpy()
        psnr = float(result['metrics']['PSNR'])
        timers = trainer.timers
        loop_s = sum(timers[k].total for k in (
            'training_iteration', '_update_occupancy', '_resize_batch',
            '_log_progress') if k in timers)
        print(f'{tag}: train.main dnerf.yaml TRAINING.NUM_ITERATIONS='
              f'{iterations}: whole run {wall:.1f} s, training loop '
              f'{loop_s:.2f} s = {iterations / loop_s:.2f} it/s, '
              f'{timers["training_iteration"].mean * 1e3:.2f} ms per '
              f'training_iteration, final rays/batch '
              f'{trainer.rays_per_batch} [{card}]')
        for line in (Path(result['output_dir']) / 'timings.txt'
                     ).read_text().splitlines():
            print(f'{tag}: timings.txt: {line}')
        print(f'{tag}: peak torch.cuda.max_memory_allocated of the training '
              f'run {torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB '
              f'[{card}]')
        print(f'{tag}: loss mean of iterations 0-49 {losses[:50].mean():.6f}'
              f', of the last 50 {losses[-50:].mean():.6f}')
        print(f'{tag}: test metrics after {iterations} iterations: ' +
              ', '.join(f'{k}={v:.4f}' for k, v in result['metrics'].items())
              + f' (untrained {psnr_before:.3f} dB) [{card}]')
        xbar = ('hash_xbar_fwd', 'hash_xbar_bwd', 'hash_xbar_bwd_pos',
                'hash_xbar_bwd_fused')
        shown = {k: launches[k] for k in xbar + ('block_probe_xyz',
                                                 'block_probe')}
        print(f'{tag}: kernel launches in the training run: {shown}',
              flush=True)
        probe_only(launches, f'{tag} training')
        if launches['hash_xbar_bwd_fused'] != iterations:
            fail(f'{tag}: hash_xbar_bwd_fused launched '
                 f'{launches["hash_xbar_bwd_fused"]} times in {iterations} '
                 'iterations')
        if len(losses) != iterations or not np.isfinite(losses).all():
            fail(f'{tag}: training loss is missing or not finite')
        if not losses[-50:].mean() < losses[:50].mean():
            fail(f'{tag}: the training loss did not fall')
        model = trainer.model
        out_layer = float(model.module.deform_mlp[-1].weight.abs().max())
        points = torch.rand((4096, 3), generator=torch.Generator().manual_seed(
            0)).to(model.device) * 1.6 - 0.8
        with torch.no_grad():
            offsets = [model.deform(points, torch.full((4096,), t,
                                                       device=model.device))
                       - points for t in (0.25, 0.75)]
        moved = float((offsets[0] - offsets[1]).abs().max())
        print(f'{tag}: deformation output layer max |w| {out_layer:.3e}; '
              f'offsets at t = 1/4 and 3/4 differ by up to {moved:.4f} '
              f'(mean |offset| {float(offsets[0].norm(dim=-1).mean()):.4f},'
              f' {float(offsets[1].norm(dim=-1).mean()):.4f})')
        if not out_layer > 0.0 or not moved > 1e-3:
            fail(f'{tag}: the deformation field did not train')
        if not (np.isfinite(psnr) and psnr >= psnr_before + 5.0):
            fail(f'{tag}: test PSNR {psnr:.3f} dB is not 5 dB above the '
                 f'untrained model\'s {psnr_before:.3f} dB')
        profile_device(lambda: trainer.training_iteration(None, iterations),
                       f'{tag}: profile of one training step', card)

        with fwd_sizes('phase 11 D-NeRF serving'):
            served, served_launches = _launches_of(lambda: inference.main(
                ['-d', str(result['output_dir']), '-s', 'test', '-m', '-b',
                 '--repeats', '1']), wrappers)
        metrics = served['metrics']['test']
        shown = {k: served_launches[k] for k in ('hash_xbar_fwd',
                                                 'block_probe_xyz',
                                                 'block_probe')}
        print(f'{tag}: inference -d RUN -s test -m -b --repeats 1: '
              f'{served["fps"]:.3f} FPS at 400x400, served test metrics: ' +
              ', '.join(f'{k}={v:.4f}' for k, v in metrics.items()) +
              f'; launches {shown} [{card}]', flush=True)
        if served_launches['hash_xbar_fwd'] <= 0:
            fail(f'{tag}: serving never launched hash_xbar_fwd')
        probe_only(served_launches, f'{tag} serving')
        if not float(metrics['PSNR']) >= psnr_before + 5.0:
            fail(f'{tag}: the served test PSNR {metrics["PSNR"]:.3f} dB is '
                 f'not 5 dB above the untrained model\'s {psnr_before:.3f} dB')

        with fwd_sizes('phase 11 static control training'):
            control, control_launches = _launches_of(lambda: train.main(
                args + ['GLOBAL.METHOD_TYPE=InstantNGP',
                        f'TRAINING.NUM_ITERATIONS={iterations}',
                        'TRAINING.MODEL_NAME=static_control']), wrappers)
        step = control['trainer'].timers['training_iteration']
        print(f'{tag}: static control, Instant-NGP (crossbar, exact corners) '
              f'with the same config on the same scene, {iterations} '
              f'iterations: test PSNR {control["metrics"]["PSNR"]:.3f} dB, '
              f'{step.mean * 1e3:.2f} ms per training_iteration (D-NeRF '
              f'{psnr:.3f} dB); launches '
              f'{ {k: control_launches[k] for k in xbar} } [{card}]',
              flush=True)
        probe_only(control_launches, f'{tag} static control')
    counts = {'hash_xbar_bwd_fused': launches['hash_xbar_bwd_fused']}
    for name in ('hash_xbar_fwd', 'hash_xbar_bwd'):
        counts[name] = launches[name] + control_launches[name] + \
            served_launches[name]
    return counts


# The deformation MLP learns through the position gradient, a sum over
# corners of +-(g . v_c) terms that mostly cancel, so the bf16 noise of the
# cotangent g is amplified there: the JAX package's own jitted and eager
# gradients of the CPU tests' D-NeRF step differ by up to 2.9e-2 relative
# Frobenius in the deformation's first layer over seeds 7-16 (1.2e-2 at
# most in the field), and the card against the CPU gave 1.3e-2 to 4.4e-2
# over seeds 0-5 on an H100 (the card's atomic sums vary from run to run).
DEFORM_FROBENIUS_RTOL = 1e-1


def phase12_dnerf_step(card: str, seed: int = 0) -> None:
    """One exact D-NeRF training step at a small width (the CPU tests'
    config: 4 levels at 2^11, a 32 x 2 deformation MLP, 32x32 dynamic
    scene) through the trainer's own code on the card and on the CPU: same
    weights (the deformation's output layer non-zero, so every layer has a
    gradient), grid, rays, background, march seed and offset-prior points.
    Loss 1e-5 relative; the field's gradients 2e-2 relative Frobenius (the
    bf16 noise floor), the deformation MLP's DEFORM_FROBENIUS_RTOL, all
    non-zero; #11 and #12 launched once, from one fused call."""
    import numpy as np
    import torch

    from nerficg_torch.core.config import ConfigNode
    from nerficg_torch.core.logging import Logger
    from nerficg_torch.core.registry import Datasets, Methods
    from nerficg_torch.data.synthetic import make_dynamic_textured_scene
    from nerficg_torch.methods.instant_ngp.convert import params_to_numpy

    with tempfile.TemporaryDirectory(prefix='chip_smoke_dnerf_step_') as tmp:
        scene = make_dynamic_textured_scene(Path(tmp) / 'scene',
                                            image_size=32, n_train=8,
                                            n_test=1)
        config = ConfigNode({
            'GLOBAL': {'METHOD_TYPE': 'DNeRF', 'DATASET_TYPE': 'DNeRF',
                       'RANDOM_SEED': 0, 'LOG_LEVEL': 'SILENT'},
            'DATASET': {'PATH': str(scene)},
            'MODEL': {'NUM_LEVELS': 4, 'LOG2_HASHMAP_SIZE': 11,
                      'BASE_RESOLUTION': 4, 'TARGET_RESOLUTION': 64,
                      'GRID_RESOLUTION': 32, 'SCALE': 1.0,
                      'DEFORM_WIDTH': 32, 'DEFORM_LAYERS': 2},
            'RENDERER': {'MAX_SAMPLES': 64, 'RAY_BATCH_SIZE': 1024},
            'TRAINING': {'INITIAL_RAYS_PER_BATCH': 256,
                         'TARGET_BATCH_SIZE': 8192}})
        Logger.set_level('SILENT')
        rng = np.random.default_rng(seed)
        points = rng.uniform(-1, 1, (4096, 3)).astype(np.float32)
        times = rng.uniform(0, 1, 4096).astype(np.float32)
        trainers, tree = {}, None
        for role, device in (('card', 'cuda'), ('cpu', 'cpu')):
            trainer = Methods.get_training_instance(config, device=device)
            if tree is None:
                shapes = trainer.model.params_tree()

                def he_uniform(w, bound=None):
                    bound = np.sqrt(6.0 / w.shape[0]) if bound is None \
                        else bound
                    return rng.uniform(-bound, bound, w.shape).astype(
                        np.float32)
                tree = {'hash_table': he_uniform(shapes['hash_table'], 0.1)}
                for name in ('density_mlp', 'color_mlp', 'deform_mlp'):
                    tree[name] = [he_uniform(w) for w in shapes[name]]
                tree['deform_mlp'][-1] = he_uniform(tree['deform_mlp'][-1],
                                                    0.05)
            trainer.model.load_params_tree(tree)
            trainer.model.buffers['density_grid'] = torch.as_tensor(
                shell_density_grid(32, 2, 1.0, thickness_cells=6.0),
                device=device)
            trainer._init_samplers(Datasets.get_dataset(config))
            fixed = (torch.as_tensor(points, device=device),
                     torch.as_tensor(times, device=device))
            trainer._draw_offset_points = lambda _, fixed=fixed: fixed
            trainers[role] = trainer
        Logger.set_level('NORMAL')
        ids = rng.integers(0, trainers['cpu']._pool_size, 256)
        bg = rng.random(3).astype(np.float32)
        logs, grads = {}, {}
        for role, trainer in trainers.items():
            device = trainer.device

            def step():
                return trainer.loss_and_grads(
                    torch.as_tensor(ids, device=device),
                    torch.as_tensor(bg, device=device), 0x2545F491, 0)
            if role == 'card':
                logs[role], launches = _launches_of(step,
                                                    _training_wrappers())
            else:
                logs[role] = step()
            grads[role] = params_to_numpy(
                {k: p.grad for k, p in trainer.model.module.named_parameters()})
    loss_g, loss_c = (float(logs[r]['total']) for r in ('card', 'cpu'))
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    print(f'phase 12: D-NeRF step, loss card {loss_g:.8f}, CPU {loss_c:.8f}, '
          f'relative error {loss_err:.2e} (limit 1e-5); '
          f'{int(logs["card"]["num_samples"])} samples; hash_xbar_bwd_fused '
          f'launched {launches["hash_xbar_bwd_fused"]} time(s) [{card}]')
    bad = []
    for name in ('hash_table', 'density_mlp', 'color_mlp', 'deform_mlp'):
        pairs = zip(*(grads[r][name] if name != 'hash_table'
                      else [grads[r][name]] for r in ('card', 'cpu')))
        limit = DEFORM_FROBENIUS_RTOL if name == 'deform_mlp' else 2e-2
        for i, (g, c) in enumerate(pairs):
            frob = _rel_frobenius(g, c)
            print(f'phase 12: gradient {name}[{i}]: relative Frobenius '
                  f'{frob:.2e} (limit {limit:.0e}), norm '
                  f'{np.linalg.norm(c):.3e}')
            if not (frob <= limit and np.linalg.norm(c) > 0.0):
                bad.append(f'{name}[{i}]')
    if launches['hash_xbar_bwd_fused'] != 1:
        fail('phase 12: the step did not launch the fused crossbar backward '
             f'once: {launches}')
    if not loss_err <= 1e-5:
        fail(f'phase 12: card and CPU losses differ by {loss_err:.2e}')
    if bad:
        fail(f'phase 12: card and CPU gradients disagree or vanish: {bad}')


def phase13_op_api(card: str) -> dict:
    """The op API's entry points with no caller among the methods, as a user
    calls them: ``composite_tiles`` (#13, #14 through autograd) on the slot
    windows of bench.py's 1080p frame, and ``xbar_permute`` (#5) on a
    262,144-sample stream permuted by blocks of 8, and the crossbar's
    position gradient alone (#12): ``hash_encode_xbar_posgrad`` through a
    frozen 16 x 2^14 table, 262,144 samples. Checks: the composite's
    rows 0-4 equal the stream compositor's (#15) image of the frame (atol
    1e-5), its three padding rows and the gradient past each count are
    zero, the gradient is finite; the permutation equals
    ``permute_block_channels`` bit for bit; the position gradient equals
    ``hash_xbar_bwd_pos_plain`` bit for bit. Returns their launch counts."""
    import numpy as np
    import torch

    from nerficg_torch.ops import gs_tiles_kernel as gtk
    from nerficg_torch.ops import hash_xbar as hx
    from nerficg_torch.ops.hashgrid import HashGridConfig
    from nerficg_torch.ops.occupancy import occupancy_probe_block_xyz
    from nerficg_torch.ops.sample_sort import permute_block_channels
    from nerficg_torch.ops.xbar_gather import (block_probe_cells,
                                               block_probe_cells_plain,
                                               build_block_bitfield,
                                               xbar_permute)
    from nerficg_torch.scripts.kernel_timing import gs_frame, gs_model

    args16 = gs_frame(gs_model('cuda'), 1920, 1080)
    with torch.no_grad():
        image, _ = gtk.gs_composite_fwd(*args16)
        slots, counts, origins = slot_windows(args16)
    rng = np.random.default_rng(13)
    dout = torch.from_numpy(rng.normal(size=(args16[4], 8, gtk.P))
                            .astype(np.float32)).cuda()
    n, block = 262144, 8
    perm = torch.from_numpy(rng.permutation(n // block)).cuda()
    perm_inv = torch.argsort(perm)
    idx = (perm[:, None] * block + torch.arange(block, device='cuda')
           ).reshape(-1).to(torch.int32)
    channels = torch.from_numpy(rng.normal(size=(4, n)).astype(
        np.float32)).cuda()
    xconfig = HashGridConfig(num_levels=16, features_per_level=2,
                             log2_table_size=14, base_resolution=16,
                             target_resolution=2048)
    xtable = torch.from_numpy(rng.uniform(-1, 1, (16, 2, 128, 128)).astype(
        np.float32)).cuda()
    xpos = torch.from_numpy(rng.uniform(0, 1 - 1e-6, (n, 3)).astype(
        np.float32)).cuda()
    xcot = torch.from_numpy(rng.normal(size=(n, 32)).astype(
        np.float32)).cuda()
    # The probe of unit coordinates (the op API's; the marcher probes world
    # planes): 262,144 points of a 128^3 shell grid, cap 2048.
    res, cap = 128, 2048
    ptable = build_block_bitfield(torch.from_numpy(
        shell_density_grid(res, 1, 1.0) > 0).cuda(), res, cap)
    units = [torch.from_numpy(rng.uniform(-0.05, 1.05, n).astype(
        np.float32)).cuda() for _ in range(3)]
    wrappers = {'gs_tiles_fwd': gtk.gs_tiles_fwd,
                'gs_tiles_bwd': gtk.gs_tiles_bwd,
                'xbar_permute': xbar_permute,
                'hash_xbar_bwd_pos': hx.hash_xbar_bwd_pos,
                'block_probe': block_probe_cells}

    def run():
        x = slots.detach().requires_grad_(True)
        out = gtk.composite_tiles(x, counts, origins)
        (out * dout).sum().backward()
        p = xpos.clone().requires_grad_(True)
        (hx.hash_encode_xbar_posgrad(xtable, p, xconfig) * xcot).sum() \
            .backward()
        return out.detach(), x.grad, xbar_permute(channels.T.contiguous(),
                                                  idx), p.grad, \
            occupancy_probe_block_xyz(ptable, *units, res, cap)
    (out, grad, permuted, dpos, occupied), launches = _launches_of(
        run, wrappers)
    want_occupied = block_probe_cells_plain(
        ptable, *(torch.clamp((u * res).to(torch.int32), 0, res - 1)
                  for u in units), 0, res, cap)
    want_dpos = hx.hash_xbar_bwd_pos_plain(xtable, xpos, xcot, xconfig)
    past = torch.arange(slots.shape[1], device='cuda')[None] >= \
        counts[:, None].long()
    err = float((out[:, :5] - image).abs().max())
    want = permute_block_channels(channels, block, perm, perm_inv).T
    print(f'phase 13: composite_tiles on the 1080p frame\'s slots '
          f'{tuple(slots.shape)}: rows 0-4 vs the stream compositor max '
          f'|diff| {err:.3e} (limit 1e-5); d slots finite '
          f'{bool(torch.isfinite(grad).all())}, max |d slots| '
          f'{float(grad.abs().max()):.3e}; xbar_permute of ({n},4) rows '
          f'bit-equal to permute_block_channels '
          f'{bool(torch.equal(permuted, want))}; position gradient of a '
          f'frozen 16 x 2^14 crossbar, {n} samples, bit-equal to '
          f'hash_xbar_bwd_pos_plain {bool(torch.equal(dpos, want_dpos))}, '
          f'max |dpos| {float(dpos.abs().max()):.3e}; '
          f'occupancy_probe_block_xyz of {n} unit points bit-equal to its '
          f'plain version {bool(torch.equal(occupied, want_occupied))}; '
          f'launches {launches} [{card}]', flush=True)
    if not err <= 1e-5 or bool(out[:, 5:].any()):
        fail('phase 13: composite_tiles disagrees with the stream compositor')
    if not bool(torch.isfinite(grad).all()) or bool(grad[past].any()):
        fail('phase 13: the slot gradient is not finite or not zero past '
             'each count')
    if not torch.equal(permuted.view(torch.int32), want.view(torch.int32)):
        fail('phase 13: xbar_permute disagrees with permute_block_channels')
    if not torch.equal(dpos, want_dpos) or not float(dpos.abs().max()) > 0:
        fail('phase 13: the position gradient disagrees with '
             'hash_xbar_bwd_pos_plain or vanishes')
    if not torch.equal(occupied, want_occupied):
        fail('phase 13: occupancy_probe_block_xyz disagrees with '
             'block_probe_cells_plain')
    if any(v != 1 for v in launches.values()):
        fail(f'phase 13: each op-API kernel should launch once: {launches}')
    return launches


# NeRF's iterations in phase 14: 150 of the config's 500,000, for the time
# limit (2000 until phase 17 came, 500 until phase 19 came, 250 until
# phase 20 came; on an H100 2000 raised the served test PSNR from 9.6 to
# 25.0 dB, 1000 to 24.1, 500 to 22.0, 250 to 20.0 and 200 to 19.4, above
# the +5 dB checked).
NERF_ITERATIONS = 150


def render_small(run_dir: Path, scene: Path, device: str) -> dict:
    """The first test view of ``scene`` rendered on ``device`` by a run
    dir's model, through the port's registry."""
    from nerficg_torch.core.registry import Datasets, Methods
    from nerficg_torch.core.setup import setup
    ctx = setup(run_dir / 'training_config.yaml', [f'DATASET.PATH={scene}'],
                device=device)
    view = Datasets.get_dataset(ctx.config).subsets['test'][0]
    model = Methods.get_model(ctx.config, device=ctx.device,
                              checkpoint=str(run_dir / 'checkpoints' /
                                             'final.ckpt'))
    out = Methods.get_renderer(ctx.config, model).render_image(view)
    return {k: v.float().cpu() for k, v in out.items()}


def phase14_nerf(card: str, scene: Path,
                 iterations: int = NERF_ITERATIONS) -> None:
    """Vanilla NeRF at the library's width (nerficg_torch/configs/nerf.yaml:
    8 x 256 coarse and fine blocks, 256 samples per ray, 1024 rays per
    step) through the training entry point on the 400x400 textured scene
    for ``iterations`` of its 500,000, after an untrained run for the
    baseline PSNR; the loss must fall and the test PSNR rise by 5 dB.
    Then a profile of one warm step (the GEMMs' share of its busy time),
    serving through the inference entry point (the served PSNR 5 dB above
    the untrained one), and the card's render of a 32x32 view against the
    CPU's (>= 45 dB). NeRF runs no kernel of the port: its MLPs are GEMMs,
    its sampling and compositing plain PyTorch."""
    import numpy as np
    import torch

    from nerficg_torch.core.setup import Directories
    from nerficg_torch.data.synthetic import make_textured_scene
    from nerficg_torch.scripts import inference, train

    tag = 'phase 14'
    wrappers = _training_wrappers()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_nerf_') as tmp:
        Directories.base = Path(tmp) / 'output'
        args = ['-c', str(ROOT / 'nerficg_torch' / 'configs' / 'nerf.yaml'),
                f'DATASET.PATH={scene}']
        start = time.perf_counter()
        before = train.main(args + ['TRAINING.NUM_ITERATIONS=0',
                                    'TRAINING.MODEL_NAME=untrained'])
        psnr_before = float(before['metrics']['PSNR'])
        print(f'{tag}: untrained NeRF: test PSNR {psnr_before:.3f} dB, '
              f'whole run (4 test views rendered) '
              f'{time.perf_counter() - start:.1f} s [{card}]', flush=True)

        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        result, launches = _launches_of(lambda: train.main(
            args + [f'TRAINING.NUM_ITERATIONS={iterations}',
                    'TRAINING.MODEL_NAME=chip_smoke']), wrappers)
        wall = time.perf_counter() - start
        trainer = result['trainer']
        losses = torch.stack(trainer.losses).float().cpu().numpy()
        psnr = float(result['metrics']['PSNR'])
        step = trainer.timers['training_iteration']
        print(f'{tag}: train.main nerf.yaml TRAINING.NUM_ITERATIONS='
              f'{iterations}: whole run {wall:.1f} s, '
              f'{step.mean * 1e3:.2f} ms per training_iteration = '
              f'{1.0 / step.mean:.2f} it/s [{card}]')
        for line in (Path(result['output_dir']) / 'timings.txt'
                     ).read_text().splitlines():
            print(f'{tag}: timings.txt: {line}')
        print(f'{tag}: peak torch.cuda.max_memory_allocated of the training '
              f'run {torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB '
              f'[{card}]')
        print(f'{tag}: loss mean of iterations 0-49 {losses[:50].mean():.6f}'
              f', of the last 50 {losses[-50:].mean():.6f}')
        print(f'{tag}: test metrics after {iterations} iterations: ' +
              ', '.join(f'{k}={v:.4f}' for k, v in result['metrics'].items())
              + f' (untrained {psnr_before:.3f} dB) [{card}]')
        print(f'{tag}: the port\'s kernels launched in the training run '
              f'(none expected): { {k: v for k, v in launches.items() if v} }',
              flush=True)
        if len(losses) != iterations or not np.isfinite(losses).all():
            fail(f'{tag}: training loss is missing or not finite')
        if not losses[-50:].mean() < losses[:50].mean():
            fail(f'{tag}: the training loss did not fall')
        if not (np.isfinite(psnr) and psnr >= psnr_before + 5.0):
            fail(f'{tag}: test PSNR {psnr:.3f} dB is not 5 dB above the '
                 f'untrained model\'s {psnr_before:.3f} dB')
        profile_device(lambda: trainer.training_iteration(None, iterations),
                       f'{tag}: profile of one training step', card, 'gemm')

        run_dir = Path(result['output_dir'])
        start = time.perf_counter()
        served = inference.main(['-d', str(run_dir), '-s', 'test', '-m',
                                 '-b', '--repeats', '1'])
        metrics = served['metrics']['test']
        print(f'{tag}: inference -d RUN -s test -m -b --repeats 1: '
              f'{served["fps"]:.3f} FPS at 400x400, whole run '
              f'{time.perf_counter() - start:.1f} s; served test metrics: ' +
              ', '.join(f'{k}={v:.4f}' for k, v in metrics.items()) +
              f' [{card}]', flush=True)
        if not all(np.isfinite(v) for v in (metrics['PSNR'], served['fps'])):
            fail(f'{tag}: non-finite served metrics or FPS: {metrics}')
        if not float(metrics['PSNR']) >= psnr_before + 5.0:
            fail(f'{tag}: the served test PSNR {metrics["PSNR"]:.3f} dB is '
                 f'not 5 dB above the untrained model\'s {psnr_before:.3f} '
                 'dB')

        small = make_textured_scene(Path(tmp) / 'small', image_size=32,
                                    n_train=1, n_test=1)
        gpu = render_small(run_dir, small, 'cuda')
        cpu = render_small(run_dir, small, 'cpu')
        for key in ('rgb', 'alpha'):
            db = _psnr_db(gpu[key], cpu[key])
            print(f'{tag}: 32x32 {key} of the trained model, card vs CPU: '
                  f'PSNR {db:.1f} dB (limit 45)')
            if not db >= 45.0:
                fail(f'{tag}: card and CPU renders disagree on {key}: '
                     f'{db:.1f} dB')


# Phase 16's capture: the 400x400 textured scene as a Mip-NeRF 360 capture,
# images_4 cropped to rows 50-349 (400x300) beside a 1600x1200 model, and
# an SfM cloud of 100,000 points on the sphere plus 2% outliers.
CAPTURE_ROWS = (50, 350)
CAPTURE_POINTS = 100_000
CAPTURE_ITERATIONS = 1000


def write_capture(root: Path, scene: Path, rows=CAPTURE_ROWS,
                  n_points: int = CAPTURE_POINTS, outlier_share: float = 0.02,
                  seed: int = 0, image_dir: str = 'images_4',
                  model_scale: int = 4,
                  second_scale: float | None = None) -> Path:
    """A COLMAP capture of a ``make_textured_scene`` directory, by default
    in Mip-NeRF 360's layout (the same writer as tests/
    test_torch_colmap.py's ``write_capture``, binary only): every view
    (train, then test) as ``image_dir/{k:03d}.png`` (RGB on black, rows
    ``rows`` kept); ``sparse/0/cameras.bin``, one PINHOLE camera at
    ``model_scale`` x the images' size whose centre moves with the crop,
    and with ``second_scale`` a second one at that factor of the first,
    which every odd view has, its image resized by the factor (Lanczos);
    ``images.bin``, each view's w2c (the inverse of the NeRF loader's
    ``opengl_to_colmap`` c2w) as a wxyz quaternion and translation, with
    two 2D observations; ``points3D.bin``, ``n_points`` on the sphere
    (radius 0.8) coloured as the images show them and ``outlier_share``
    more uniform in a cube of side 8, each with a two-entry track."""
    import math
    import struct

    import numpy as np
    from PIL import Image

    from nerficg_torch.cameras.pose import rotation_matrix_to_quaternion
    from nerficg_torch.data.loaders.nerf import (BLENDER_TO_COLMAP_WORLD,
                                                 opengl_to_colmap)
    from nerficg_torch.data.synthetic import _texture_fn

    model = root / 'sparse' / '0'
    model.mkdir(parents=True, exist_ok=True)
    (root / image_dir).mkdir(parents=True, exist_ok=True)
    top, bottom = rows
    images, index = [], 0
    for split in ('train', 'test'):
        meta = json.loads((scene / f'transforms_{split}.json').read_text())
        for frame in meta['frames']:
            rgba = np.asarray(Image.open(scene / (frame['file_path'][2:] +
                                                  '.png')))
            height, width = rgba.shape[:2]
            name = f'{index:03d}.png'
            image = Image.fromarray(rgba[top:bottom, :, :3])
            camera_id = 1
            if second_scale is not None and index % 2:
                camera_id = 2
                image = image.resize(
                    (round(width * second_scale),
                     round((bottom - top) * second_scale)), Image.LANCZOS)
            image.save(root / image_dir / name)
            w2c = np.linalg.inv(opengl_to_colmap(
                np.asarray(frame['transform_matrix'])))
            images.append((index + 1,
                           rotation_matrix_to_quaternion(w2c[:3, :3]),
                           w2c[:3, 3], camera_id, name))
            index += 1
        focal = 0.5 * width / math.tan(0.5 * meta['camera_angle_x'])
    scales = [model_scale] if second_scale is None else \
        [model_scale, model_scale * second_scale]
    with open(model / 'cameras.bin', 'wb') as f:
        f.write(struct.pack('<Q', len(scales)))
        for camera_id, s in enumerate(scales, 1):
            f.write(struct.pack('<iiQQ4d', camera_id, 1, round(width * s),
                                round((bottom - top) * s), focal * s,
                                focal * s, width / 2 * s,
                                (height / 2 - top) * s))
    with open(model / 'images.bin', 'wb') as f:
        f.write(struct.pack('<Q', len(images)))
        for image_id, qvec, tvec, camera_id, name in images:
            f.write(struct.pack('<i7di', image_id, *qvec, *tvec, camera_id))
            f.write(name.encode() + b'\x00')
            f.write(struct.pack('<Qddqddq', 2, 1.5, 2.5, 0, 3.5, 4.5, -1))
    rng = np.random.default_rng(seed)
    normals = rng.normal(size=(n_points, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    light = np.array([0.5, 0.7, 0.5]) / np.linalg.norm([0.5, 0.7, 0.5])
    texture = _texture_fn(np.random.default_rng(0), (3.0, 8.0, 14.0))
    colors = texture(0.8 * normals) * \
        (0.35 + 0.65 * np.maximum(normals @ light, 0.0))[:, None]
    outliers = int(round(n_points * outlier_share))
    xyz = np.concatenate([0.8 * normals,
                          rng.uniform(-4.0, 4.0, (outliers, 3))])
    colors = np.concatenate([colors, rng.random((outliers, 3))])
    record = np.dtype([('id', '<u8'), ('xyz', '<f8', 3), ('rgb', 'u1', 3),
                       ('error', '<f8'), ('track_length', '<u8'),
                       ('track', '<i4', 4)])
    table = np.zeros(len(xyz), record)
    table['id'] = np.arange(1, len(xyz) + 1)
    table['xyz'] = xyz @ BLENDER_TO_COLMAP_WORLD[:3, :3].T
    table['rgb'] = np.round(colors * 255).astype(np.uint8)
    table['error'] = 0.5
    table['track_length'] = 2
    table['track'] = [1, 0, 2, 1]
    with open(model / 'points3D.bin', 'wb') as f:
        f.write(struct.pack('<Q', len(table)))
        f.write(table.tobytes())
    return root


def phase16_capture(card: str, scene: Path,
                    iterations: int = CAPTURE_ITERATIONS,
                    work: Path | None = None) -> dict:
    """The COLMAP capture path of 3DGS through the port's four entry
    points on ``write_capture``'s capture of ``scene``: create_config -m
    GaussianSplatting -d MipNeRF360 (the library's defaults: SH 4,
    DOWNSAMPLE 4, TEST_STEP 8, PCA alignment); train for 0 iterations (the
    SfM-initialised model, its test PSNR the baseline) and ``iterations``
    of the config's 30,000 (densification every 100 from 600); a profile
    of one warm step; convert_to_ply; inference -s test ellipse_path -m -b.
    Checks: #15 (16-wide) and #16 once per step, the packed #15 once per
    served, trajectory and benchmark frame; the loss falls; the test PSNR
    rises by 3 dB; the PLY holds one vertex per active Gaussian, equal to
    the final checkpoint's parameters bit for bit; the trajectory's 120
    frames are finite and of the camera's shape. Returns the GS kernels'
    launches of the training run (#15, #16) and the serving run (packed).
    The capture and run directories go under ``work`` when it is given
    (and stay)."""
    import numpy as np
    import torch

    from nerficg_torch.core.checkpoint import load_checkpoint
    from nerficg_torch.core.registry import Datasets
    from nerficg_torch.core.setup import Directories
    from nerficg_torch.data.ply import read_ply_vertices
    from nerficg_torch.scripts import (convert_to_ply, create_config,
                                       inference, train)
    from nerficg_torch.visual.trajectories import CameraTrajectory

    tag = 'phase 16'
    phase_start = time.perf_counter()
    wrappers = _gs_wrappers()
    with _work_dir(work, 'chip_smoke_capture_') as tmp:
        tmp = Path(tmp)
        start = time.perf_counter()
        capture = write_capture(tmp / 'capture', scene)
        config = tmp / 'm360.yaml'
        create_config.main(['-m', 'GaussianSplatting', '-d', 'MipNeRF360',
                            '-o', str(config), '-p', str(capture)])
        print(f'{tag}: Mip-NeRF 360 capture of the 400x400 scene (34 views '
              f'as images_4 of 400x300, a 1600x1200 PINHOLE model, '
              f'{CAPTURE_POINTS} SfM points + 2% outliers) and '
              f'create_config -m GaussianSplatting -d MipNeRF360 in '
              f'{time.perf_counter() - start:.1f} s', flush=True)
        Directories.base = tmp / 'output'
        args = ['-c', str(config)]
        before = train.main(args + ['TRAINING.NUM_ITERATIONS=0',
                                    'TRAINING.MODEL_NAME=untrained'])
        psnr_before = float(before['metrics']['PSNR'])
        dataset = Datasets.get_dataset(before['trainer']._config)
        camera = dataset.subsets['train'][0].camera
        n_test = len(dataset.subsets['test'])
        start_count = len(dataset.point_cloud)
        print(f'{tag}: the SfM-initialised model (iteration 0, '
              f'{start_count} Gaussians): test PSNR {psnr_before:.3f} dB on '
              f'{n_test} test views of {camera.width}x{camera.height} '
              f'[{card}]', flush=True)

        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        result, launches = _launches_of(lambda: train.main(
            args + [f'TRAINING.NUM_ITERATIONS={iterations}',
                    'TRAINING.MODEL_NAME=chip_smoke']), wrappers)
        wall = time.perf_counter() - start
        peak = torch.cuda.max_memory_allocated()
        trainer = result['trainer']
        losses = torch.stack(trainer.losses).float().cpu().numpy()
        psnr = float(result['metrics']['PSNR'])
        step = trainer.timers['training_iteration']
        print(f'{tag}: train.main TRAINING.NUM_ITERATIONS={iterations}: '
              f'whole run {wall:.1f} s, {step.mean * 1e3:.2f} ms per '
              f'training_iteration, Gaussians {start_count} at start, '
              f'{trainer.model.num_active} after the bake; peak '
              f'torch.cuda.max_memory_allocated {peak / 2 ** 20:.1f} MiB '
              f'[{card}]')
        for line in (Path(result['output_dir']) / 'timings.txt'
                     ).read_text().splitlines():
            print(f'{tag}: timings.txt: {line}')
        print(f'{tag}: loss mean of iterations 0-49 {losses[:50].mean():.6f}'
              f', of the last 50 {losses[-50:].mean():.6f}; test metrics: ' +
              ', '.join(f'{k}={v:.4f}' for k, v in result['metrics'].items())
              + f' (iteration 0: {psnr_before:.3f} dB) [{card}]')
        print(f'{tag}: kernel launches in the training run: {launches}',
              flush=True)
        for name in ('gs_composite_fwd', 'gs_composite_bwd'):
            if launches[name] != iterations:
                fail(f'{tag}: {name} launched {launches[name]} times in '
                     f'{iterations} steps')
        check_frontend_launches(tag, launches)
        if len(losses) != iterations or not np.isfinite(losses).all():
            fail(f'{tag}: training loss is missing or not finite')
        if not losses[-50:].mean() < losses[:50].mean():
            fail(f'{tag}: the training loss did not fall')
        if not (np.isfinite(psnr) and psnr >= psnr_before + 3.0):
            fail(f'{tag}: test PSNR {psnr:.3f} dB is not 3 dB above the '
                 f'SfM-initialised model\'s {psnr_before:.3f} dB')
        # One warm step on the baked model, with a fresh optimizer.
        trainer._build_optimizer()
        trainer._reset_densify_stats()
        profile_device(lambda: trainer.training_iteration(dataset,
                                                          iterations),
                       f'{tag}: profile of one training step', card)

        run_dir = Path(result['output_dir'])
        ply = convert_to_ply.main(['-d', str(run_dir)])
        vertices = read_ply_vertices(ply)
        params = load_checkpoint(run_dir / 'checkpoints' / 'final.ckpt'
                                 )['params']
        active = trainer.model.num_active
        rest = params['features_rest'][:active].transpose(0, 2, 1).reshape(
            active, -1)
        columns = {'positions': ('x', 'y', 'z'),
                   'features_dc': tuple(f'f_dc_{i}' for i in range(3)),
                   'features_rest': tuple(f'f_rest_{i}'
                                          for i in range(rest.shape[1])),
                   'opacities': ('opacity',),
                   'scales': tuple(f'scale_{i}' for i in range(3)),
                   'rotations': tuple(f'rot_{i}' for i in range(4))}
        want = {'features_rest': rest,
                'features_dc': params['features_dc'][:active, 0]}
        equal = len(vertices['x']) == active
        for key, names in columns.items():
            got = np.stack([vertices[n] for n in names], -1)
            value = want.get(key, params[key][:active])
            equal = equal and got.shape == value.shape and \
                np.array_equal(got, value)
        print(f'{tag}: convert_to_ply: {ply.stat().st_size} bytes, '
              f'{len(vertices["x"])} vertices ({active} active Gaussians), '
              f'{len(vertices)} properties, equal to final.ckpt bit for bit: '
              f'{equal}', flush=True)
        if not equal:
            fail(f'{tag}: the PLY does not hold the checkpoint\'s '
                 'parameters')

        repeats = 3
        served, served_launches = _launches_of(lambda: inference.main(
            ['-d', str(run_dir), '-s', 'test', 'ellipse_path', '-m', '-b',
             '--repeats', str(repeats)]), wrappers)
        metrics = served['metrics']['test']
        frames = sorted((run_dir / 'ellipse_path' / 'rgb').iterdir())
        expected = n_test + len(frames) + 1 + repeats * n_test
        print(f'{tag}: inference -s test ellipse_path -m -b --repeats '
              f'{repeats}: {served["fps"]:.3f} FPS at '
              f'{camera.width}x{camera.height}; served test metrics: ' +
              ', '.join(f'{k}={v:.4f}' for k, v in metrics.items()) +
              f'; {len(frames)} trajectory frames; launches '
              f'{served_launches} ({expected} frames) [{card}]', flush=True)
        if served_launches['gs_composite_fwd_packed'] != expected or \
                served_launches['gs_composite_fwd'] or \
                served_launches['gs_composite_bwd']:
            fail(f'{tag}: serving should launch the packed #15 once per '
                 f'frame ({expected}) and nothing else: {served_launches}')
        check_frontend_launches(tag, served_launches)
        if not abs(float(metrics['PSNR']) - psnr) <= 0.05:
            fail(f'{tag}: the served test PSNR {metrics["PSNR"]:.3f} dB is '
                 f'not the trainer\'s {psnr:.3f} dB')
        # The trajectory's frames again, as tensors: finite, of the
        # camera's shape.
        renderer, _ = load_renderer(run_dir, 'cuda')
        views = CameraTrajectory.get('ellipse_path').generate(dataset, 120)
        shapes = set()
        finite = True
        for view in views:
            out = renderer.render_image(view)
            shapes.add(tuple(out['rgb'].shape))
            finite = finite and all(bool(torch.isfinite(v).all())
                                    for v in out.values())
        seconds = time.perf_counter() - phase_start
        print(f'{tag}: ellipse_path: {len(views)} frames, rgb shapes '
              f'{sorted(shapes)}, finite {finite}; the phase took '
              f'{seconds:.1f} s [{card}]', flush=True)
        if len(frames) != 120 or shapes != {(camera.height, camera.width,
                                             3)} or not finite:
            fail(f'{tag}: the trajectory\'s frames are missing, misshapen or '
                 'not finite')
    return {'gs_composite_fwd': launches['gs_composite_fwd'],
            'gs_composite_bwd': launches['gs_composite_bwd'],
            'gs_composite_fwd_packed':
                served_launches['gs_composite_fwd_packed'],
            'gs_frontend_fwd': launches['gs_frontend_fwd'] +
                served_launches['gs_frontend_fwd'],
            'gs_frontend_bwd': launches['gs_frontend_bwd'],
            'gs_stream_gather': launches['gs_stream_gather'] +
                served_launches['gs_stream_gather'],
            'gs_stream_gather_bwd': launches['gs_stream_gather_bwd']}


# Phase 17: the interactive viewer. Poses are posted as a browser would
# (theta, phi) at the median distance of the run's training cameras from
# the origin, which each scene's objects surround; 5 for 3DGS, 1 for
# Instant-NGP, whose 800x800 frames take seconds each (2 until phase 20
# came: the second took ~20 s of the script, a frame and its reference).
VIEWER_POSES = ((0.0, 0.25), (1.3, -0.2), (2.6, 0.35), (3.9, 0.1),
                (5.2, -0.3))
VIEWER_INGP_POSES = 1
# A served frame shows a pose when its decoded JPEG is this close to the
# JPEG of the smoke's own render of the pose (both PIL quality 90): #7's
# atomic sums differ in their last bits between the two processes.
VIEWER_MIN_PSNR_DB = 40.0
# Two poses' renders must lie this far apart, so that a frame of one pose
# cannot pass for the next.
VIEWER_POSES_APART_DB = 30.0
VIEWER_DEADLINE_S = 120.0
GUI_TRAIN_ITERATIONS = 200
GUI_PROFILE_AT = 150
GUI_PROFILE_STEPS = 5
# #15's 16-wide forward and #16 as named in a trace: gs_tiles.cu's
# gs_fwd_kernel with the stream layout (0) and saved transmittance, and
# gs_bwd_kernel with the stream layout.
TRACE_KERNELS = {'gs_composite_fwd': 'gs_fwd_kernel<0, true>',
                 'gs_composite_bwd': 'gs_bwd_kernel<0>'}


def viewer_child(argv_json: str, result_path: str) -> None:
    """Phase 17's subprocess: ``nerficg_torch.scripts.gui.main`` with the
    given arguments, as ``python -m nerficg_torch.scripts.gui`` runs it,
    then its kernel launches, every traceback ``catch`` logged and the
    training run's directory written to ``result_path`` as JSON."""
    import torch

    from nerficg_torch.core import errors
    from nerficg_torch.scripts import gui
    wrappers = {**_training_wrappers(), **_gs_wrappers()}
    for fn in wrappers.values():
        fn.launches = 0
    trainer = gui.main(json.loads(argv_json))
    torch.cuda.synchronize()
    Path(result_path).write_text(json.dumps({
        'launches': {k: fn.launches for k, fn in wrappers.items()},
        'caught': sorted(errors._seen_tracebacks),
        'output_dir': None if trainer is None else
            str(Path(trainer.output_dir).resolve())}))


class ViewerProcess:
    """``python -m nerficg_torch.scripts.gui`` with ``argv`` in a
    subprocess of its own process group (the viewer it spawns included),
    its output in ``log``, and HTTP to its viewer on a free port."""

    def __init__(self, argv: list, cwd: Path, tag: str):
        import os
        import socket
        with socket.socket() as probe:
            probe.bind(('127.0.0.1', 0))
            self.port = probe.getsockname()[1]
        self.tag = tag
        self.log = cwd / 'viewer.log'
        self.result = cwd / 'viewer.json'
        code = (f'import sys; sys.path.insert(0, {str(ROOT)!r}); '
                'import chip_smoke; chip_smoke.viewer_child(*sys.argv[1:])')
        self.started = time.perf_counter()
        with open(self.log, 'w') as log:
            self.proc = subprocess.Popen(
                [sys.executable, '-c', code,
                 json.dumps([*argv, '--port', str(self.port)]),
                 str(self.result)], cwd=cwd, stdout=log,
                stderr=subprocess.STDOUT, start_new_session=True,
                env={**os.environ, 'PYTHONUNBUFFERED': '1'})

    def url(self, path: str) -> str:
        return f'http://127.0.0.1:{self.port}{path}'

    def get(self, path: str) -> bytes:
        import urllib.request
        with urllib.request.urlopen(self.url(path), timeout=30) as reply:
            return reply.read()

    def post(self, path: str, body: dict | None = None) -> None:
        import urllib.request
        request = urllib.request.Request(
            self.url(path), data=json.dumps(body or {}).encode(),
            method='POST')
        urllib.request.urlopen(request, timeout=30).read()

    def status(self) -> dict:
        return json.loads(self.get('/status'))

    def alive(self) -> bool:
        return self.proc.poll() is None

    def wait_listening(self, frame: bool = False) -> float:
        """Seconds from the start until ``/status`` answers or, with
        ``frame``, until ``/frame.jpg`` holds a first frame (the viewer
        answers while the model loads)."""
        import numpy as np

        from nerficg_torch.gui.web_viewer import _encode_jpeg
        placeholder = _encode_jpeg(np.zeros((8, 8, 3), np.float32))
        while True:
            if not self.alive():
                self.fail_with_log('exited before its viewer answered')
            try:
                if not frame:
                    self.status()
                    return time.perf_counter() - self.started
                if self.get('/frame.jpg') != placeholder:
                    return time.perf_counter() - self.started
            except OSError:
                pass
            if time.perf_counter() - self.started > VIEWER_DEADLINE_S:
                self.fail_with_log('viewer did not answer')
            time.sleep(0.05)

    def finish(self) -> dict:
        """``/terminate``, then the exit (code 0 within the deadline) and
        the child's JSON; fails on any traceback ``catch`` logged."""
        self.post('/terminate')
        try:
            code = self.proc.wait(timeout=VIEWER_DEADLINE_S)
        except subprocess.TimeoutExpired:
            self.fail_with_log('did not exit after /terminate')
        if code != 0:
            self.fail_with_log(f'exited with code {code}')
        result = json.loads(self.result.read_text())
        logged = self.log.read_text().count('caught exception')
        if result['caught'] or logged:
            self.fail_with_log(f'{len(result["caught"])} tracebacks caught '
                               f'({logged} in the log): {result["caught"]}')
        return result

    def stop(self) -> None:
        """Kill the process group if anything is left of it."""
        import os
        import signal
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait()

    def fail_with_log(self, message: str) -> None:
        print(self.log.read_text()[-6000:], flush=True)
        self.stop()
        fail(f'{self.tag}: the viewer process {message}')


def _jpeg_rgb(data: bytes):
    import io

    import numpy as np
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(data)).convert('RGB'),
                      np.float32) / 255.0


def _viewer_scene(run_dir: Path):
    """(renderer, dataset, orbit radius) of a run dir on the card."""
    import numpy as np

    from nerficg_torch.core.registry import Datasets, Methods
    from nerficg_torch.core.setup import setup
    ctx = setup(run_dir / 'training_config.yaml', device='cuda')
    dataset = Datasets.get_dataset(ctx.config)
    model = Methods.get_model(ctx.config, device=ctx.device,
                              checkpoint=str(run_dir / 'checkpoints' /
                                             'final.ckpt'))
    radius = float(np.median([np.linalg.norm(v.position)
                              for v in dataset.subsets['train']]))
    return Methods.get_renderer(ctx.config, model), dataset, radius


def _expected_frames(renderer, dataset, radius: float, poses) -> list:
    """The smoke's own render of each (theta, phi) pose at the viewer's
    800x800, JPEG-encoded as the viewer encodes, decoded; checks that the
    frames show something and that no two poses look alike."""
    import numpy as np

    from nerficg_torch.gui.trainer import GuiTrainerMixin
    from nerficg_torch.gui.web_viewer import _encode_jpeg, _orbit_pose
    mixin = GuiTrainerMixin()
    frames = []
    for theta, phi in poses:
        pose = _orbit_pose(theta, phi, radius, 800, 800)
        rgb = renderer.render_image(mixin._pose_to_view(pose, dataset))['rgb']
        frames.append(_jpeg_rgb(_encode_jpeg(rgb.float().cpu().numpy())))
    for i, frame in enumerate(frames):
        if not (frame.shape == (800, 800, 3) and float(frame.std()) > 0.02):
            fail(f'phase 17: the direct render of pose {i} is empty or '
                 f'misshapen: {frame.shape}, std {float(frame.std()):.4f}')
        if i and _psnr_db(frame, frames[i - 1]) >= VIEWER_POSES_APART_DB:
            fail(f'phase 17: poses {i - 1} and {i} render alike')
    return frames


def _serve_poses(viewer: ViewerProcess, poses, frames, radius: float
                 ) -> list[tuple[float, float]]:
    """Post each pose and poll ``/frame.jpg`` until it shows the pose;
    returns (seconds from the post to that frame, PSNR) per pose."""
    out = []
    for (theta, phi), want in zip(poses, frames):
        seen = viewer.get('/frame.jpg')
        start = time.perf_counter()
        viewer.post('/camera', {'theta': theta, 'phi': phi,
                                'radius': radius})
        while True:
            data = viewer.get('/frame.jpg')
            if data != seen:
                seen = data
                got = _jpeg_rgb(data)
                if got.shape == want.shape:
                    db = _psnr_db(got, want)
                    if db >= VIEWER_MIN_PSNR_DB:
                        out.append((time.perf_counter() - start, db))
                        break
            if time.perf_counter() - start > VIEWER_DEADLINE_S:
                viewer.fail_with_log(f'never served pose ({theta}, {phi})')
            if not viewer.alive():
                viewer.fail_with_log('exited while serving')
            time.sleep(0.002)
    return out


def _status_fps(viewer: ViewerProcess, seconds: float) -> list[float]:
    """``/status``'s FPS, read every half second for ``seconds``."""
    readings = []
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        time.sleep(0.5)
        readings.append(float(viewer.status()['fps']))
    return readings


def phase17_checkpoint_viewer(card: str, name: str, run_dir: Path,
                              poses, tmp: Path) -> dict:
    """``python -m nerficg_torch.scripts.gui -d RUN_DIR`` in a subprocess:
    each pose posted to ``/camera`` until ``/frame.jpg`` shows it (held to
    the smoke's own render of the pose), ``/status``'s FPS, then
    ``/terminate``. Returns the subprocess's kernel launches."""
    import numpy as np

    tag = f'phase 17 {name} viewer'
    work = tmp / name
    work.mkdir()
    start = time.perf_counter()
    viewer = ViewerProcess(['-d', str(run_dir)], work, tag)
    try:
        renderer, dataset, radius = _viewer_scene(run_dir)
        frames = _expected_frames(renderer, dataset, radius, poses)
        del renderer
        first = viewer.wait_listening(frame=True)
        served = _serve_poses(viewer, poses, frames, radius)
        fps = _status_fps(viewer, 3.0)
        result = viewer.finish()
    finally:
        viewer.stop()
    latencies = [s for s, _ in served]
    print(f'{tag}: gui -d RUN_DIR at 800x800: the first frame (the first '
          f'train view) {first:.1f} s after the start; {len(poses)} poses, '
          f'pose-to-frame latency '
          f'median {np.median(latencies) * 1e3:.1f} ms (each: ' +
          ', '.join(f'{s * 1e3:.1f}' for s in latencies) + ' ms), served '
          'frames vs the direct render ' +
          ', '.join(f'{db:.1f}' for _, db in served) + ' dB (limit '
          f'{VIEWER_MIN_PSNR_DB:.0f}); /status FPS on the last pose ' +
          ', '.join(f'{f:.2f}' for f in fps) + f'; the run '
          f'{time.perf_counter() - start:.1f} s [{card}]', flush=True)
    launches = {k: v for k, v in result['launches'].items() if v}
    print(f'{tag}: kernel launches in the viewer process: {launches}',
          flush=True)
    return result['launches']


def phase17_handoff(card: str) -> None:
    """The viewer hand-off's host cost at 800x800, apart from any render:
    ``SharedState.push_frame`` (the float32 frame pickled through the
    Manager), ``pop_frame`` (the viewer's side) and ``_encode_jpeg``."""
    import numpy as np

    from nerficg_torch.gui.state import SharedState
    from nerficg_torch.gui.web_viewer import _encode_jpeg
    frame = np.random.default_rng(0).random((800, 800, 3)).astype(np.float32)
    state = SharedState()
    times = {'push_frame': [], 'pop_frame': [], '_encode_jpeg': []}
    for _ in range(20):
        for name, fn in (('push_frame', lambda: state.push_frame(frame)),
                         ('pop_frame', lambda: state.pop_frame()),
                         ('_encode_jpeg', lambda: _encode_jpeg(frame))):
            start = time.perf_counter()
            fn()
            times[name].append((time.perf_counter() - start) * 1e3)
    print('phase 17: hand-off of an 800x800 float32 frame (7.68 MB), host '
          'ms over 20 calls, median (min-max): ' + '; '.join(
              f'{k} {np.median(v):.2f} ({min(v):.2f}-{max(v):.2f})'
              for k, v in times.items()) + f' [{card}]', flush=True)
    state._manager.shutdown()


def _timings(run_dir: Path) -> dict:
    """timings.txt as {callback: (total s, calls)}."""
    out = {}
    for line in (run_dir / 'timings.txt').read_text().splitlines():
        if ': total ' in line:
            name, rest = line.split(': total ')
            total, calls = rest.split('s over ')
            out[name] = (float(total), int(calls.split()[0]))
    return out


def phase17_gui_training(card: str, scene: Path, tmp: Path) -> dict:
    """``python -m nerficg_torch.scripts.gui --train`` on the GS config
    (the library's defaults, 100k random points) on the 400x400 scene for
    GUI_TRAIN_ITERATIONS iterations with TRAINING.TIMING.PROFILE over 5 of
    them in the middle, a pose posted so that the frames every 25
    iterations are 800x800; ``/status`` from training to idle, then the
    post-training frame held to the smoke's render of the final
    checkpoint at that pose, ``/terminate``, final.ckpt and a trace that
    holds #15 and #16. Then the same run (its profile window included) in
    this process without the viewer (phase 9's protocol) for the GUI's
    cost per step. Returns the subprocess's kernel launches."""
    import numpy as np

    from nerficg_torch.core.setup import Directories
    from nerficg_torch.scripts import train

    tag = 'phase 17 GUI-attached 3DGS training'
    work = tmp / 'gui_train'
    work.mkdir()
    args = ['-c', str(_gs_config_path()), f'DATASET.PATH={scene}',
            f'TRAINING.NUM_ITERATIONS={GUI_TRAIN_ITERATIONS}',
            'TRAINING.MODEL_NAME=gui']
    pose = {'theta': 0.8, 'phi': 0.3, 'radius': 4.0}
    start = time.perf_counter()
    profile = [f'TRAINING.TIMING.PROFILE={GUI_PROFILE_AT}',
               f'TRAINING.TIMING.PROFILE_STEPS={GUI_PROFILE_STEPS}']
    viewer = ViewerProcess(['--train', *args, *profile], work, tag)
    try:
        viewer.wait_listening()
        viewer.post('/camera', pose)
        seen_training, iterations = False, []
        while True:
            status = viewer.status()
            seen_training |= bool(status['is_training'])
            iterations.append(status['training_iteration'])
            if seen_training and not status['is_training']:
                break
            if time.perf_counter() - start > 4 * VIEWER_DEADLINE_S:
                viewer.fail_with_log('training never ended')
            if not viewer.alive():
                viewer.fail_with_log('exited while training')
            time.sleep(0.2)
        trained = time.perf_counter() - start
        time.sleep(1.0)
        fps = _status_fps(viewer, 2.0)
        served = _jpeg_rgb(viewer.get('/frame.jpg'))
        result = viewer.finish()
    finally:
        viewer.stop()
    run_dir = Path(result['output_dir'])
    renderer, dataset, _ = _viewer_scene(run_dir)
    want = _expected_frames(renderer, dataset, pose['radius'],
                            [(pose['theta'], pose['phi'])])[0]
    db = _psnr_db(served, want) if served.shape == want.shape else 0.0
    trace_path = run_dir / 'profile' / 'trace.json'
    events = json.loads(trace_path.read_text())['traceEvents']
    in_trace = {k: sum(1 for e in events if pattern in e.get('name', ''))
                for k, pattern in TRACE_KERNELS.items()}
    timings = _timings(run_dir)
    print(f'{tag}: gui --train gaussian_splatting.yaml '
          f'TRAINING.NUM_ITERATIONS={GUI_TRAIN_ITERATIONS} '
          f'TIMING.PROFILE={GUI_PROFILE_AT}: /status training -> idle after '
          f'{trained:.1f} s (iterations seen {min(iterations)}-'
          f'{max(iterations)}); post-training /status FPS ' +
          ', '.join(f'{f:.2f}' for f in fps) + f'; the served frame vs the '
          f'final checkpoint\'s render {db:.1f} dB (limit '
          f'{VIEWER_MIN_PSNR_DB:.0f}); trace {trace_path.stat().st_size} '
          f'bytes, {len(events)} events, kernels {in_trace}; final.ckpt '
          f'{(run_dir / "checkpoints" / "final.ckpt").exists()} [{card}]',
          flush=True)
    print(f'{tag}: kernel launches in the viewer process: '
          f'{ {k: v for k, v in result["launches"].items() if v} }',
          flush=True)
    if db < VIEWER_MIN_PSNR_DB:
        fail(f'{tag}: the served frame is not the final model\'s render '
             f'({db:.1f} dB)')
    if not (run_dir / 'checkpoints' / 'final.ckpt').exists():
        fail(f'{tag}: no final.ckpt')
    if not all(in_trace.values()):
        fail(f'{tag}: the profile trace lacks a GS kernel: {in_trace}')
    for name in ('gs_composite_fwd', 'gs_composite_bwd'):
        if result['launches'][name] != GUI_TRAIN_ITERATIONS:
            fail(f'{tag}: {name} launched {result["launches"][name]} times '
                 f'in {GUI_TRAIN_ITERATIONS} steps')

    Directories.base = work / 'plain'
    plain = train.main(args + profile + ['TRAINING.MODEL_NAME=plain'])
    plain_timings = _timings(Path(plain['output_dir']))
    loop = ('training_iteration', '_densify', '_reset_opacity',
            '_increase_sh_degree', '_log_progress')
    for label, t in (('with the viewer', timings),
                     ('without (in this process)', plain_timings)):
        step = t['training_iteration']
        gui = t.get('_gui_render_frame', (0.0, 0))
        loop_s = sum(t[k][0] for k in (*loop, '_gui_render_frame')
                     if k in t)
        print(f'{tag}: {label}: {step[0] / step[1] * 1e3:.2f} ms per '
              f'training_iteration, _gui_render_frame {gui[0]:.3f} s over '
              f'{gui[1]} calls, training loop {loop_s:.2f} s = '
              f'{loop_s / GUI_TRAIN_ITERATIONS * 1e3:.2f} ms a step '
              f'[{card}]', flush=True)
    print(f'{tag}: the phase took {time.perf_counter() - start:.1f} s',
          flush=True)
    return result['launches']


def phase17_viewer(card: str, scene: Path, ingp_run: Path,
                   gs_run: Path) -> dict:
    """The interactive viewer on the card: the 3DGS and Instant-NGP
    checkpoint viewers, the hand-off's host cost, GUI-attached 3DGS
    training. Returns the kernel launches of its three viewer processes,
    summed."""
    start = time.perf_counter()
    launches = collections.Counter()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_viewer_') as tmp:
        tmp = Path(tmp)
        launches.update(phase17_checkpoint_viewer(card, '3DGS', gs_run,
                                                  VIEWER_POSES, tmp))
        phase17_handoff(card)
        launches.update(phase17_checkpoint_viewer(
            card, 'Instant-NGP', ingp_run, VIEWER_POSES[:VIEWER_INGP_POSES],
            tmp))
        launches.update(phase17_gui_training(card, scene, tmp))
    for name in ('hash_window_fwd', 'block_probe_xyz', 'seg_gather',
                 'seg_scatter_add', 'gs_composite_fwd',
                 'gs_composite_fwd_packed', 'gs_composite_bwd'):
        if launches[name] <= 0:
            fail(f'phase 17: {name} never launched by the viewers')
    print(f'phase 17: the phase took {time.perf_counter() - start:.1f} s '
          f'[{card}]', flush=True)
    return dict(launches)


# Phase 18: the data layer on the card. (a) phase 16's scene as a Colmap
# capture whose views alternate between two PINHOLE cameras, the odd ones
# resized to 320x240 (0.8 x 400x300); (b) a Ricoh360 capture of 30
# panoramas of 256x128 (every 8th a test view: 4). Both train Instant-NGP
# with configs/ingp_e2e_bench.yaml's MODEL, RENDERER and TRAINING.
DATA_ITERATIONS = 300
PANORAMA_VIEWS = 30
PANORAMA_SIZE = (256, 128)
SECOND_CAMERA_SCALE = 0.8


def write_panoramas(root: Path, count: int = PANORAMA_VIEWS,
                    size=PANORAMA_SIZE, ss: int = 2) -> Path:
    """A Ricoh360 capture (the writer of tests/test_torch_data_loaders.py's
    ``write_panoramas``, one split): ``transforms_train.json`` and
    ``count`` RGB PNGs of ``size``, each an equirectangular image of
    ``make_textured_scene``'s sphere (its texture, seed 0, Lambertian
    shading on black, ``ss`` x supersampled; pixel centres at
    EquirectangularCamera's angles), its camera on the scene's ring
    (distance 4, elevations 20 and -25 degrees alternating, facing the
    origin)."""
    import math

    import numpy as np
    from PIL import Image

    from nerficg_torch.data.synthetic import (_pose_on_ring, _shade_sphere,
                                              _texture_fn)

    texture = _texture_fn(np.random.default_rng(0), (3.0, 8.0, 14.0))
    width, height = size
    ys, xs = np.mgrid[0:height * ss, 0:width * ss].astype(np.float64) + 0.5
    theta = (xs / (width * ss) - 0.5) * 2.0 * math.pi
    phi = (0.5 - ys / (height * ss)) * math.pi
    local = np.stack([np.cos(phi) * np.sin(theta), -np.sin(phi),
                      np.cos(phi) * np.cos(theta)], -1)
    (root / 'train').mkdir(parents=True, exist_ok=True)
    frames = []
    for i in range(count):
        c2w = _pose_on_ring(2 * math.pi * i / count,
                            math.radians(-25.0 if i % 2 else 20.0))
        rgb, _ = _shade_sphere(texture, c2w[:3, 3], local @ c2w[:3, :3].T,
                               np.zeros(3))
        rgb = rgb.reshape(height, ss, width, ss, 3).mean(axis=(1, 3))
        Image.fromarray((np.clip(rgb, 0, 1) * 255).astype(np.uint8)).save(
            root / 'train' / f'r_{i}.png')
        c2w_gl = c2w.copy()
        c2w_gl[:3, 1:3] *= -1
        frames.append({'file_path': f'./train/r_{i}',
                       'time': i / max(count - 1, 1),
                       'transform_matrix': c2w_gl.tolist()})
    (root / 'transforms_train.json').write_text(json.dumps({'frames': frames}))
    return root


def e2e_overrides() -> list[str]:
    """configs/ingp_e2e_bench.yaml's seed, MODEL, RENDERER and TRAINING as
    command-line overrides (but its iterations, run name and test render)."""
    import yaml
    config = yaml.safe_load((ROOT / 'configs' / 'ingp_e2e_bench.yaml')
                            .read_text())
    out = [f'GLOBAL.RANDOM_SEED={config["GLOBAL"]["RANDOM_SEED"]}']
    for section in ('MODEL', 'RENDERER', 'TRAINING'):
        out += [f'{section}.{key}={value}'
                for key, value in config[section].items()
                if key not in ('NUM_ITERATIONS', 'MODEL_NAME',
                               'RENDER_TESTSET')]
    return out


@contextlib.contextmanager
def ray_pool_paths():
    """Counts the calls of BaseDataset's two pool paths while open:
    {'shared': calls of ``_shared_camera_rays`` (the grouped path calls it
    once per camera), 'grouped': the camera groups of each
    ``_grouped_rays`` call}."""
    from nerficg_torch.data.base import BaseDataset
    shared = BaseDataset._shared_camera_rays
    grouped = BaseDataset._grouped_rays.__func__
    calls = {'shared': 0, 'grouped': []}

    def count_shared(views, device, *args):
        calls['shared'] += 1
        return shared(views, device, *args)

    def count_grouped(cls, views, groups, device, *args):
        calls['grouped'].append(len(groups))
        return grouped(cls, views, groups, device, *args)

    BaseDataset._shared_camera_rays = staticmethod(count_shared)
    BaseDataset._grouped_rays = classmethod(count_grouped)
    try:
        yield calls
    finally:
        BaseDataset._shared_camera_rays = staticmethod(shared)
        BaseDataset._grouped_rays = classmethod(grouped)


def check_ray_pool(tag: str, dataset, groups: int, card: str) -> dict:
    """The training pool built on the card against the one built on the
    CPU (origins and directions to 1e-6, every other field exactly), and
    the path it took: ``_grouped_rays`` once with ``groups`` cameras, or
    (``groups`` 1) the shared path alone. Returns its seconds and size."""
    import torch
    with ray_pool_paths() as paths:
        start = time.perf_counter()
        on_card = dataset.precompute_rays('train', device='cuda')
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    on_host = dataset.precompute_rays('train', device='cpu')
    worst, unequal = 0.0, []
    for name in ('origins', 'directions', 'view_directions', 'rgb', 'alpha',
                 'depth', 'timestamps', 'pixel_ids', 'view_ids'):
        a, b = getattr(on_card.rays, name), getattr(on_host.rays, name)
        if a is None and b is None:
            continue
        if a is None or b is None or a.shape != b.shape or \
                a.dtype != b.dtype:
            unequal.append(name)
        elif name in ('origins', 'directions', 'view_directions'):
            worst = max(worst, float((a.cpu() - b).abs().max()))
        elif not torch.equal(a.cpu(), b):
            unequal.append(name)
    rays = len(on_card.rays)
    expected = {'shared': groups, 'grouped': [groups] if groups > 1 else []}
    print(f'{tag}: precompute_rays(train) on the card: {rays} rays of '
          f'{len(on_card.view_slices)} views in {seconds:.3f} s, paths '
          f'{paths} (expected {expected}); against the CPU pool: origins '
          f'and directions max |diff| {worst:.3e} (limit 1e-6), other fields '
          f'{"equal" if not unequal else f"UNEQUAL {unequal}"}, slices '
          f'equal {on_card.view_slices == on_host.view_slices} [{card}]',
          flush=True)
    if paths != expected:
        fail(f'{tag}: the pool took the paths {paths}, not {expected}')
    if worst > 1e-6 or unequal or on_card.view_slices != on_host.view_slices:
        fail(f'{tag}: the pool on the card differs from the CPU\'s')
    if on_card.rays.origins.device.type != 'cuda':
        fail(f'{tag}: the pool asked for on cuda is on '
             f'{on_card.rays.origins.device}')
    return {'seconds': seconds, 'rays': rays}


def phase18_run(card: str, run: str, capture: Path, dataset_type: str,
                overrides: tuple, groups: int, tmp: Path) -> dict:
    """One capture through the port's entry points: create_config -m
    InstantNGP -d ``dataset_type``; train with the e2e config's MODEL,
    RENDERER and TRAINING and ``overrides`` for 0 iterations (carving and
    the warm-up grid: the baseline) and DATA_ITERATIONS; the pool's check;
    inference -d RUN -s test -m -b. Checks the kernels' launches (the
    stochastic forward once per step and grid refresh, the cached backward
    once per step; the marcher's
    probe, gather and scatter in training and serving; the exact forward
    in serving; never block_probe_cells or xbar_gather), the loss falling,
    the test PSNR 3 dB above the baseline trained and served, and finite
    served renders. Returns the launches, training and serving summed."""
    import numpy as np
    import torch

    from nerficg_torch.core.registry import Datasets
    from nerficg_torch.core.setup import Directories
    from nerficg_torch.scripts import create_config, inference, train

    tag = f'phase 18{run}'
    wrappers = _training_wrappers()
    config = tmp / f'{dataset_type}.yaml'
    create_config.main(['-m', 'InstantNGP', '-d', dataset_type, '-o',
                        str(config), '-p', str(capture)])
    Directories.base = tmp / 'output'
    args = ['-c', str(config), *e2e_overrides(), 'TRAINING.RENDER_TESTSET=True',
            *overrides]
    before = train.main(args + ['TRAINING.NUM_ITERATIONS=0',
                                'TRAINING.MODEL_NAME=untrained'])
    psnr_before = float(before['metrics']['PSNR'])
    cfg = before['trainer']._config

    start = time.perf_counter()
    dataset = Datasets.get_dataset(cfg)
    load_s = time.perf_counter() - start
    start = time.perf_counter()
    dataset.preload()
    decode_s = time.perf_counter() - start
    cameras = {id(v.camera): v.camera for v in dataset.all_views()}
    sizes = sorted(f'{type(c).__name__} {c.width}x{c.height}'
                   for c in cameras.values())
    print(f'{tag}: create_config -m InstantNGP -d {dataset_type}; '
          f'{len(dataset.subsets["train"])} train and '
          f'{len(dataset.subsets["test"])} test views, cameras {sizes}; '
          f'normalisation DATASET.NORMALIZE_PCA='
          f'{cfg.DATASET.get("NORMALIZE_PCA", "n/a")} NORMALIZE_CUBE='
          f'{cfg.DATASET.NORMALIZE_CUBE} NORMALIZE_RECENTER='
          f'{cfg.DATASET.NORMALIZE_RECENTER}, MODEL.SCALE={cfg.MODEL.SCALE} '
          f'(the sphere, radius 0.8 at the origin, inside the box of half '
          f'extent {cfg.MODEL.SCALE}); load: dataset {load_s:.3f} s, decode '
          f'{decode_s:.3f} s; untrained model (carved, warm-up grid): test '
          f'PSNR {psnr_before:.3f} dB [{card}]', flush=True)
    pool = check_ray_pool(tag, dataset, groups, card)
    del dataset

    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    result, launches = _launches_of(lambda: train.main(
        args + [f'TRAINING.NUM_ITERATIONS={DATA_ITERATIONS}',
                'TRAINING.MODEL_NAME=chip_smoke']), wrappers)
    wall = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    trainer = result['trainer']
    losses = torch.stack(trainer.losses).float().cpu().numpy()
    psnr = float(result['metrics']['PSNR'])
    step = trainer.timers['training_iteration']
    trained = ('hash_window_fwd_stoch', 'hash_window_bwd_cached',
               'block_probe_xyz', 'seg_gather', 'seg_scatter_add')
    print(f'{tag}: train.main TRAINING.NUM_ITERATIONS={DATA_ITERATIONS}: '
          f'whole run {wall:.1f} s, {step.mean * 1e3:.2f} ms per '
          f'training_iteration, final rays/batch {trainer.rays_per_batch}, '
          f'peak torch.cuda.max_memory_allocated {peak:.1f} MiB [{card}]')
    print(f'{tag}: loss mean of iterations 0-49 {losses[:50].mean():.6f}, '
          f'of the last 50 {losses[-50:].mean():.6f}; test metrics: ' +
          ', '.join(f'{k}={v:.4f}' for k, v in result['metrics'].items()) +
          f' (untrained {psnr_before:.3f} dB) [{card}]')
    # The grid refreshes (the warm-up's and one every 16 iterations) encode
    # their cells through the stochastic forward too.
    refreshes = sum(trainer.timers[k].count for k in
                    ('_warmup_occupancy', '_update_occupancy'))
    print(f'{tag}: kernel launches in the training run: '
          f'{ {k: launches[k] for k in trained} } ({DATA_ITERATIONS} steps, '
          f'{refreshes} grid refreshes)', flush=True)
    if launches['hash_window_bwd_cached'] != DATA_ITERATIONS or \
            launches['hash_window_fwd_stoch'] != DATA_ITERATIONS + refreshes:
        fail(f'{tag}: the stochastic forward and the cached backward should '
             'launch once per step (the forward once per grid refresh too)')
    missing = [k for k in trained if launches[k] <= 0]
    if missing:
        fail(f'{tag}: kernels never launched while training: {missing}')
    probe_only(launches, f'{tag} training')
    if len(losses) != DATA_ITERATIONS or not np.isfinite(losses).all():
        fail(f'{tag}: training loss is missing or not finite')
    if not losses[-50:].mean() < losses[:50].mean():
        fail(f'{tag}: the training loss did not fall')
    if not (np.isfinite(psnr) and psnr >= psnr_before + 3.0):
        fail(f'{tag}: test PSNR {psnr:.3f} dB is not 3 dB above the '
             f'untrained model\'s {psnr_before:.3f} dB')
    counts = {k: launches[k] for k in trained}

    run_dir = Path(result['output_dir'])
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    served, launches = _launches_of(lambda: inference.main(
        ['-d', str(run_dir), '-s', 'test', '-m', '-b', '--repeats', '1']),
        wrappers)
    wall = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    metrics = served['metrics']['test']
    serving = ('hash_window_fwd', 'block_probe_xyz', 'seg_gather',
               'seg_scatter_add')
    print(f'{tag}: inference -d RUN -s test -m -b --repeats 1: '
          f'{served["fps"]:.3f} FPS, whole run {wall:.1f} s, peak '
          f'torch.cuda.max_memory_allocated {peak:.1f} MiB; served test '
          f'metrics: ' + ', '.join(f'{k}={v:.4f}' for k, v in metrics.items())
          + f'; launches { {k: launches[k] for k in serving} } [{card}]',
          flush=True)
    missing = [k for k in serving if launches[k] <= 0]
    if missing:
        fail(f'{tag}: kernels never launched while serving: {missing}')
    probe_only(launches, f'{tag} serving')
    if not float(metrics['PSNR']) >= psnr_before + 3.0:
        fail(f'{tag}: the served test PSNR {metrics["PSNR"]:.3f} dB is not '
             f'3 dB above the untrained model\'s {psnr_before:.3f} dB')
    renderer, views = load_renderer(run_dir, 'cuda')
    finite = all(bool(torch.isfinite(value).all())
                 for view in views
                 for value in renderer.render_image(view).values())
    if not (finite and np.isfinite(served['fps'])):
        fail(f'{tag}: a served render or the FPS is not finite')
    for name in serving:
        counts[name] = counts.get(name, 0) + launches[name]
    counts['pool_rays'] = pool['rays']
    return counts


def phase18_data_layer(card: str, scene: Path) -> dict:
    """Instant-NGP on the two captures only the data layer's new modules
    load: (a) the Colmap capture with two cameras (``write_capture``,
    images beside a model at their size, phase 16's 100,000 points;
    DATASET.NORMALIZE_PCA=False keeps the scene where the e2e config's
    MODEL.SCALE 1.0 box holds it), the grouped pool path with 2 groups;
    (b) the Ricoh360 panoramas (``write_panoramas``), one
    EquirectangularCamera, the shared path, with a fixed background.
    Returns the kernels' launches of both runs summed."""
    phase_start = time.perf_counter()
    launches: dict = collections.Counter()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_data_') as tmp:
        tmp = Path(tmp)
        start = time.perf_counter()
        capture = write_capture(tmp / 'capture', scene, image_dir='images',
                                model_scale=1,
                                second_scale=SECOND_CAMERA_SCALE)
        print(f'phase 18a: Colmap capture of the 400x400 scene (34 views, '
              f'rows {CAPTURE_ROWS[0]}-{CAPTURE_ROWS[1] - 1}: even views '
              f'400x300 on PINHOLE camera 1, odd ones resized to 320x240 on '
              f'camera 2 with 0.8 x its intrinsics; {CAPTURE_POINTS} SfM '
              f'points + 2%) written in {time.perf_counter() - start:.1f} s',
              flush=True)
        launches.update(phase18_run(card, 'a', capture, 'Colmap',
                                    ('DATASET.NORMALIZE_PCA=False',), 2,
                                    tmp / 'a'))
        start = time.perf_counter()
        panoramas = write_panoramas(tmp / 'panoramas')
        print(f'phase 18b: {PANORAMA_VIEWS} Ricoh360 panoramas of '
              f'{PANORAMA_SIZE[0]}x{PANORAMA_SIZE[1]} on the ring written in '
              f'{time.perf_counter() - start:.1f} s', flush=True)
        # Departure from the e2e config: a fixed (black) background. The
        # panoramas have no alpha, so their black is part of the target, and
        # ~97% of their rays miss the box: a random background would add a
        # per-step constant of ~1/3 to the loss for each and hide its fall.
        launches.update(phase18_run(card, 'b', panoramas, 'Ricoh360',
                                    ('TRAINING.RANDOM_BACKGROUND=False',), 1,
                                    tmp / 'b'))
    launches.pop('pool_rays')
    print(f'phase 18: the phase took {time.perf_counter() - phase_start:.1f} '
          f's; kernel launches of both runs, trained and served: '
          f'{dict(launches)} [{card}]', flush=True)
    return dict(launches)


# Phase 19: the offline tools and the metric layer.
TOOLS_LPIPS_SEED = 0
TOOLS_PAIRS = 5
TOOLS_PAIR_SIZE = 400
TOOLS_SCENE_SIZE = 200
TOOLS_ITERATIONS = 150
# LPIPS, mSSIM and mPSNR on the card against the CPU: float32 convolutions
# by other algorithms (cuDNN with TF32 off, against oneDNN).
TOOLS_RTOL = 1e-4


def _close(got: float, want: float, rtol: float = TOOLS_RTOL) -> bool:
    """Within ``rtol`` relative, or absolute below 1."""
    return abs(got - want) <= rtol * max(1.0, abs(want))


def vgg_flops(height: int, width: int) -> float:
    """The VGG16 trunk's convolution operations (2 per multiply-add) on one
    image, as optim/lpips.py computes it."""
    from nerficg_torch.optim.lpips import _VGG_CFG
    total, cin = 0.0, 3
    for block, (n_convs, cout) in enumerate(_VGG_CFG):
        if block:
            height, width = height // 2, width // 2
        for _ in range(n_convs):
            total += 2.0 * 9 * cin * cout * height * width
            cin = cout
    return total


def phase19_doctor(card: str) -> None:
    """``nerficg_torch.scripts.install.main([])``, the doctor, in this
    process (its log read back): exit 0."""
    import io

    from nerficg_torch.core.logging import Logger
    from nerficg_torch.scripts import install
    start = time.perf_counter()
    log, level = io.StringIO(), Logger.level
    Logger.set_level('NORMAL')
    try:
        with contextlib.redirect_stderr(log):
            code = install.main([])
    except SystemExit as exc:
        code = exc.code
    finally:
        Logger.level = level
    lines = [line for line in log.getvalue().splitlines()
             if any(key in line for key in ('torch ', 'card:', 'kernel '
                                            'library', 'environment',
                                            'dataset loaders', 'ERROR'))]
    print(f'phase 19a: install (the doctor) returned {code} in '
          f'{time.perf_counter() - start:.1f} s: ' + ' | '.join(lines) +
          f' [{card}]', flush=True)
    if code != 0:
        print(log.getvalue()[-4000:])
        fail('phase 19a: the doctor found a problem')


def phase19_metrics(card: str, npz: Path) -> None:
    """LPIPS (the weights file ``npz``), mSSIM and mPSNR of TOOLS_PAIRS
    pairs at TOOLS_PAIR_SIZE on the card against the CPU; one mask empty,
    one full, the rest discs."""
    import numpy as np
    import torch

    from nerficg_torch.optim.lpips import load_weights, lpips_vgg
    from nerficg_torch.optim.masked_metrics import masked_psnr, masked_ssim

    rng = np.random.default_rng(19)
    size = TOOLS_PAIR_SIZE
    ys, xs = np.mgrid[0:size, 0:size] / size
    pairs = []
    for k in range(TOOLS_PAIRS):
        # Smooth content plus fine noise, the target a perturbed copy.
        base = 0.5 + 0.4 * np.sin(2 * np.pi * (xs * (k + 1) + ys * 2))
        a = np.clip(base[..., None] * rng.uniform(0.5, 1.0, 3)
                    + 0.05 * rng.standard_normal((size, size, 3)), 0, 1)
        b = np.clip(a + 0.08 * rng.standard_normal(a.shape), 0, 1)
        mask = ((ys - 0.5) ** 2 + (xs - 0.3 - 0.1 * k) ** 2 < 0.06)
        mask = {0: np.zeros_like(mask), 1: np.ones_like(mask)}.get(k, mask)
        pairs.append((a.astype(np.float32), b.astype(np.float32),
                      mask.astype(np.float32)))
    params = {'cuda': load_weights(npz, 'cuda'), 'cpu': load_weights(npz,
                                                                     'cpu')}
    lpips_vgg(*pairs[0][:2], params=params['cuda'], device='cuda')  # warm-up
    values = {'cuda': [], 'cpu': []}
    seconds = {'cuda': [], 'cpu': []}
    for device in ('cuda', 'cpu'):
        for a, b, mask in pairs:
            start = time.perf_counter()
            lp = lpips_vgg(a, b, params=params[device], device=device)
            seconds[device].append(time.perf_counter() - start)
            p, t, m = (torch.as_tensor(x, device=device) for x in (a, b, mask))
            values[device].append((lp, float(masked_ssim(p, t, m)),
                                   float(masked_psnr(p, t, m))))
    # The card's time a pair, three more passes over the pairs.
    passes = []
    for _ in range(3):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for a, b, _ in pairs:
            lpips_vgg(a, b, params=params['cuda'], device='cuda')
        passes.append((time.perf_counter() - start) / len(pairs) * 1e3)
    ms = sorted(passes)[1]
    flops = 2 * vgg_flops(size, size)
    worst = max(abs(g - w) / max(1.0, abs(w)) if j else abs(g - w) / abs(w)
                for got, want in zip(values['cuda'], values['cpu'])
                for j, (g, w) in enumerate(zip(got, want)))
    for k, (got, want) in enumerate(zip(values['cuda'], values['cpu'])):
        print(f'phase 19b: pair {k} ({size}x{size}, mask '
              f'{["empty", "full"][k] if k < 2 else "disc"}): LPIPS card '
              f'{got[0]:.6f} cpu {want[0]:.6f}; mSSIM card {got[1]:.6f} cpu '
              f'{want[1]:.6f}; mPSNR card {got[2]:.4f} cpu {want[2]:.4f} dB')
    print(f'phase 19b: LPIPS (VGG16, random weights from seed '
          f'{TOOLS_LPIPS_SEED}) on the card: {ms:.3f} ms a {size}x{size} pair '
          f'(median of 3 passes over {len(pairs)} pairs, each ending in a '
          f'synchronize: {", ".join(f"{x:.3f}" for x in passes)}), the '
          f'trunk\'s {flops / 1e9:.1f} GFLOP a pair at '
          f'{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s (f32, TF32 off; the '
          f'f32 peak is {F32_OPS_PER_S / 1e12:.0f}); the CPU '
          f'{np.median(seconds["cpu"]) * 1e3:.1f} ms a pair; card against '
          f'CPU worst {worst:.2e} relative (limit {TOOLS_RTOL:.0e}) '
          f'[{card}]', flush=True)
    if not worst <= TOOLS_RTOL:
        fail('phase 19b: LPIPS or the masked metrics differ between the '
             'card and the CPU')
    if not all(np.isfinite(v).all() and v[0] > 0 for v in values['cuda']):
        fail('phase 19b: a metric on the card is not finite or LPIPS is 0')


def _mean_metrics(run_line: str) -> dict:
    """'mean: PSNR=1.0 SSIM=...' -> {'PSNR': 1.0, ...}."""
    return {k: float(v) for k, v in (item.split('=') for item in
                                     run_line.split(': ', 1)[1].split())}


def phase19_sweep(card: str, tmp: Path) -> dict:
    """The dataset sweep on two textured scenes, sequential_train over the
    first one's config, each run a child process on the card, from ``tmp``;
    returns {scene: (run dir, scene dir)}."""
    import math
    import os

    from nerficg_torch.core.config import load_config, save_config
    from nerficg_torch.core.setup import Directories
    from nerficg_torch.data.synthetic import make_textured_scene
    from nerficg_torch.scripts import benchmark_sweep, sequential_train, train

    data = tmp / 'data'
    scenes = ('sphere_a', 'sphere_b')
    for seed, scene in enumerate(scenes):
        make_textured_scene(data / scene, image_size=TOOLS_SCENE_SIZE,
                            n_train=20, n_test=2, seed=seed)
    overrides = [*e2e_overrides(), f'TRAINING.NUM_ITERATIONS='
                 f'{TOOLS_ITERATIONS}']
    previous = (Path.cwd(), Directories.base)
    os.chdir(tmp)
    try:
        # The untrained baselines, in this process: 0 iterations (carving
        # and the warm-up grid), the test set scored.
        untrained = {}
        Directories.base = tmp / 'untrained'
        for scene in scenes:
            before = train.main([
                '-c', str(ROOT / 'configs' / 'ingp_e2e_bench.yaml'),
                *overrides, f'DATASET.PATH={data / scene}',
                'TRAINING.RENDER_TESTSET=True', 'TRAINING.NUM_ITERATIONS=0',
                'TRAINING.MODEL_NAME=untrained'])
            untrained[scene] = float(before['metrics']['PSNR'])
        start = time.perf_counter()
        rows = benchmark_sweep.main(['-m', 'InstantNGP', '-d', 'NeRF', '-p',
                                     str(data), '-o', 'output/benchmark',
                                     *overrides])
        sweep_s = time.perf_counter() - start
        config = tmp / 'sequential.yaml'
        save_config(load_config(tmp / 'output' / 'benchmark' /
                                f'{scenes[0]}.yaml',
                                overrides + ['TRAINING.MODEL_NAME='
                                             'sequential']), config)
        start = time.perf_counter()
        results = sequential_train.main([str(config), '-o',
                                         'output/summary.txt'])
        sequential_s = time.perf_counter() - start
    finally:
        os.chdir(previous[0])
        Directories.base = previous[1]
    summary = (tmp / 'output' / 'benchmark' / 'summary.txt').read_text()
    print(f'phase 19c: benchmark_sweep -m InstantNGP -d NeRF over 2 '
          f'{TOOLS_SCENE_SIZE}x{TOOLS_SCENE_SIZE} textured scenes (20 train, '
          f'2 test views), the e2e config at {TOOLS_ITERATIONS} iterations, '
          f'in {sweep_s:.1f} s; untrained test PSNR '
          f'{ {k: round(v, 3) for k, v in untrained.items()} }; summary.txt:\n'
          + summary.rstrip() + f'\n[{card}]', flush=True)
    runs = {}
    for scene, info in rows:
        if not info['metrics'].startswith('mean: '):
            fail(f'phase 19c: the sweep\'s {scene} run has no metrics: '
                 f'{info}')
        metrics = _mean_metrics(info['metrics'])
        if not math.isfinite(metrics.get('LPIPS', math.nan)):
            fail(f'phase 19c: {scene}\'s metrics_8bit.txt has no finite '
                 f'LPIPS: {info["metrics"]}')
        if not metrics['PSNR'] > untrained[scene]:
            fail(f'phase 19c: {scene}\'s test PSNR {metrics["PSNR"]:.3f} dB is '
                 f'not above the untrained run\'s {untrained[scene]:.3f}')
        if f'{scene}: {info["metrics"]} | time ' not in summary:
            fail(f'phase 19c: summary.txt has no row for {scene}')
        run_dir = sorted((tmp / 'output' / 'InstantNGPModel').glob(
            f'{scene}_*'))[-1]
        runs[scene] = (run_dir, data / scene)
    line = (tmp / 'output' / 'summary.txt').read_text().strip()
    print(f'phase 19c: sequential_train over {config.name} in '
          f'{sequential_s:.1f} s: {line} [{card}]', flush=True)
    if len(results) != 1 or 'LPIPS=' not in results[0][1]:
        fail(f'phase 19c: sequential_train\'s summary is {results}')
    return runs


def phase19_tables(card: str, tmp: Path, runs: dict) -> None:
    """generate_tables --mask-name over the sweep's test renders laid out as
    root/scene/InstantNGP, beside gt/ (the test views composited as the
    renderer scores them) and masks/ (their alpha), on the card; every
    row's values recomputed on the CPU."""
    import math

    from nerficg_torch.core.config import load_config
    from nerficg_torch.core.registry import Datasets
    from nerficg_torch.data.io import save_image
    from nerficg_torch.scripts import generate_tables

    root = tmp / 'tables'
    for scene, (run_dir, _) in runs.items():
        config = load_config(run_dir / 'training_config.yaml')
        views = Datasets.get_dataset(config).subsets['test']
        for i, view in enumerate(views):
            alpha = view.alpha
            gt = view.rgb[..., :3] * alpha + \
                view.camera.background_color * (1.0 - alpha)
            save_image(gt, root / scene / 'gt' / f'{i:05d}.png')
            save_image(alpha, root / scene / 'masks' / f'{i:05d}.png')
            (root / scene / 'InstantNGP').mkdir(parents=True, exist_ok=True)
            (root / scene / 'InstantNGP' / f'{i:05d}.png').write_bytes(
                (run_dir / 'test' / 'rgb' / f'{i:05d}.png').read_bytes())
    start = time.perf_counter()
    rows = generate_tables.main(['-r', str(root), '-m', 'masks', '-o',
                                 str(root / 'tables.txt')])
    card_s = time.perf_counter() - start
    cpu = generate_tables.collect_rows(root, 'gt', 'masks', device='cpu')
    worst = 0.0
    for (scene, method, got), (_, _, want) in zip(rows, cpu):
        for key, value in want.items():
            if not math.isfinite(got[key]):
                fail(f'phase 19d: {scene} {method} {key} is {got[key]}')
            worst = max(worst, abs(got[key] - value) / max(1.0, abs(value)))
    print(f'phase 19d: generate_tables -m masks on the card in {card_s:.1f} '
          f's, {len(rows)} rows:\n' +
          (root / 'tables.txt').read_text().rstrip() +
          f'\nagainst the rows recomputed on the CPU: worst {worst:.2e} '
          f'relative (limit {TOOLS_RTOL:.0e}) [{card}]', flush=True)
    if len(rows) != len(runs) or len(cpu) != len(rows) or \
            any(len(r[2]) != 6 for r in rows):
        fail(f'phase 19d: expected {len(runs)} rows of 6 metrics')
    if not worst <= TOOLS_RTOL:
        fail('phase 19d: the card\'s table differs from the CPU\'s')


def phase19_tools(card: str) -> None:
    """The doctor, LPIPS and the masked metrics card against CPU, the
    dataset sweep with sequential_train, and generate_tables over its
    renders. Their kernels (#1 stochastic and exact, #3, #4, #6, #7) run
    in the sweep's child processes and are not counted here: phase 18
    counts the same config's launches."""
    import os

    import numpy as np

    from nerficg_torch.optim.lpips import init_random_weights
    phase_start = time.perf_counter()
    phase19_doctor(card)
    with tempfile.TemporaryDirectory(prefix='chip_smoke_tools_') as tmp:
        tmp = Path(tmp)
        npz = tmp / 'lpips_vgg.npz'
        np.savez(npz, **init_random_weights(TOOLS_LPIPS_SEED))
        phase19_metrics(card, npz)
        # Every later score, in this process and the sweep's children,
        # finds the weights where a user points both packages at them.
        previous = os.environ.get('NERFICG_LPIPS_WEIGHTS')
        os.environ['NERFICG_LPIPS_WEIGHTS'] = str(npz)
        try:
            runs = phase19_sweep(card, tmp)
            phase19_tables(card, tmp, runs)
        finally:
            if previous is None:
                os.environ.pop('NERFICG_LPIPS_WEIGHTS')
            else:
                os.environ['NERFICG_LPIPS_WEIGHTS'] = previous
    print(f'phase 19: the phase took {time.perf_counter() - phase_start:.1f} '
          f's [{card}]', flush=True)


# Phase 20: the native image decoder, ray-parallel training over two ranks
# of a gloo group on the one card, and NCCL at world size 1.
DP_RANKS = 2
DP_ITERATIONS = 200          # phase 5's, for the PSNR band
# The test PSNR of two ranks must lie this close to phase 5's one-process
# run of the same config, scene and iterations: twice phase 5's own spread
# over seeds (RANDOM_SEED 0-3 on an NVIDIA H100 80GB HBM3 at 700 W: 23.58,
# 22.85, 22.96 and 23.84 dB, 0.99 dB); the ranks march with other seeds.
DP_PSNR_BAND_DB = 2 * 0.99
# One two-shard step with exact corners on the card against the same step
# in one process, both shards in turn: the table gradient's atomic sums
# differ from run to run, so the bound is tests/test_torch_training.py's
# FROBENIUS_RTOL, and the loss's LOSS_RTOL.
DP_FROBENIUS_RTOL = 2e-2
DP_LOSS_RTOL = 1e-5
DECODE_VIEWS = 100
DECODE_SIZE = 800


def phase20_decoder(card: str, tmp: Path) -> None:
    """(a) Known arrays written as 8- and 16-bit RGB/RGBA/gray(+alpha),
    2-bit gray and palette PNGs (with and without tRNS) decode natively to
    exactly those arrays; RGB and gray JPEGs to PIL's decode / 255 within
    one ulp. Then load_images_parallel of 100 800x800 RGBA PNGs, the
    native thread pool against PIL's thread pool, in turns (host
    seconds). Where the decoder does not build, prints why and times
    PIL's pool alone: the port then decodes with PIL, as the JAX package
    would."""
    import os

    import numpy as np
    from PIL import Image

    from nerficg_torch import native
    from nerficg_torch.data import io
    sys.path.insert(0, str(ROOT / 'tests'))
    from image_fixtures import write_fixtures
    start = time.perf_counter()
    path, what = native.build_library()
    available = path is not None and native.native_io_available()
    if available:
        print(f'phase 20a: native decoder {path.name} ({what}) in '
              f'{time.perf_counter() - start:.2f} s [{card}]', flush=True)
    else:
        print(f'phase 20a: the native decoder does not build here ({what});'
              f' the port decodes with PIL, as the JAX package would '
              f'[{card}]', flush=True)
    for name, (file, want) in (write_fixtures(tmp / 'fixtures').items()
                               if available else ()):
        got = native.decode_image(file)
        if want is None:
            with Image.open(file) as img:
                want = (np.asarray(img).astype(np.float32) / 255.0
                        ).reshape(got.shape)
            ulps = int(np.max(np.abs(got.view(np.int32).astype(np.int64) -
                                     want.view(np.int32))))
            ok = got.shape == want.shape and ulps <= 1
        else:
            ulps = None
            ok = got.shape == want.shape and np.array_equal(got, want)
        print(f'phase 20a: {name}: {got.shape} '
              + (f'against PIL / 255, {ulps} ulp' if ulps is not None
                 else 'equal to the known array' if ok else 'DIFFERS'))
        if not ok:
            fail(f'phase 20a: {name} decodes to {got.shape}, not the '
                 f'known {want.shape} array')
    rng = np.random.default_rng(0)
    xs = np.linspace(0.0, 1.0, DECODE_SIZE, dtype=np.float32)
    sources = []
    for i in range(4):
        base = np.stack([np.outer(xs, xs), np.outer(1 - xs, xs),
                         np.outer(xs, 1 - xs), np.outer(1 - xs, 1 - xs)],
                        -1) * 200 + rng.integers(0, 56, (DECODE_SIZE,
                                                         DECODE_SIZE, 4))
        sources.append(tmp / f'view_src{i}.png')
        Image.fromarray(base.astype(np.uint8), 'RGBA').save(sources[-1])
    paths = []
    for i in range(DECODE_VIEWS):
        paths.append(tmp / f'view{i:03d}.png')
        os.link(sources[i % 4], paths[-1])
    times = {'native': [], 'PIL': []}
    for kind in ('native', 'PIL', 'PIL', 'native') if available else \
            ('PIL', 'PIL'):
        start = time.perf_counter()
        images = io.load_images_parallel(
            paths, load_fn=None if kind == 'native' else io._load_pil)
        times[kind].append(time.perf_counter() - start)
        if len(images) != DECODE_VIEWS or images[0].shape != (
                DECODE_SIZE, DECODE_SIZE, 4):
            fail(f'phase 20a: {kind} loaded {len(images)} images of '
                 f'{images[0].shape}')
        if kind == 'native':
            decoded = images
        else:
            pil = images
    if not available:
        print(f'phase 20a: load_images_parallel of {DECODE_VIEWS} '
              f'{DECODE_SIZE}x{DECODE_SIZE} RGBA PNGs (8 threads), PIL '
              f'thread pool, host seconds: {times["PIL"][0]:.3f}, '
              f'{times["PIL"][1]:.3f} [{card}]', flush=True)
        return
    ulps = max(int(np.max(np.abs(a.view(np.int32).astype(np.int64) -
                                 b.view(np.int32))))
               for a, b in zip(decoded, pil))
    if ulps > 1:
        fail(f'phase 20a: the native and PIL decodes of the 8-bit views '
             f'differ by {ulps} ulp')
    print(f'phase 20a: load_images_parallel of {DECODE_VIEWS} '
          f'{DECODE_SIZE}x{DECODE_SIZE} RGBA PNGs (8 threads), host '
          f'seconds in turns: native {times["native"][0]:.3f}, '
          f'{times["native"][1]:.3f}; PIL thread pool {times["PIL"][0]:.3f}, '
          f'{times["PIL"][1]:.3f}; the two within {ulps} ulp (the native '
          f'decode multiplies by 1/255, PIL\'s path divides by 255) '
          f'[{card}]', flush=True)


def dp_rank(argv_json: str, result_dir: str) -> None:
    """Phase 20's rank, run by torch.distributed.run. It joins the group
    through ``setup`` (as ``train.main`` does, which then finds it up),
    takes one two-shard step with exact corners on a fresh trainer of the
    run's config (rank 0 writes the step's inputs and results to
    ``result_dir`` for the parent's one-process version) and times the
    all-reduce of its gradient buffer; then ``train.main`` with the given
    arguments, as ``python -m nerficg_torch.scripts.train`` runs it, with
    its kernel launches and a digest of the trained parameters and grid.
    Writes ``result_dir/rank<r>.json``."""
    import faulthandler
    import hashlib

    import numpy as np
    import torch

    # A rank that waits on a collective past this dumps its stack and
    # exits, so that torch.distributed.run ends and the phase fails.
    faulthandler.dump_traceback_later(200, exit=True)
    from nerficg_torch.core.config import load_config
    from nerficg_torch.core.registry import Datasets, Methods
    from nerficg_torch.core.setup import setup
    from nerficg_torch.methods.instant_ngp.convert import params_to_numpy
    from nerficg_torch.parallel.data_parallel import all_reduce_grads
    from nerficg_torch.scripts import train
    out = Path(result_dir)
    argv = json.loads(argv_json)
    config = load_config(argv[argv.index('-c') + 1],
                         [a for a in argv if '=' in a])
    config.MODEL.STOCHASTIC_CORNERS = 0
    ctx = setup(config=config, device='cuda')
    rank = ctx.rank
    wrappers = _training_wrappers()
    step_trainer = Methods.get_training_instance(config, device=ctx.device)
    dataset = Datasets.get_dataset(config)
    step_trainer._init_samplers(dataset)
    step_trainer._carve_occupancy(dataset)
    step_trainer._warmup_occupancy(dataset)
    if rank == 0:
        np.savez(out / 'step_init.npz', grid=step_trainer.model.buffers[
            'density_grid'].cpu().numpy(), **{
                f'p_{k}': v.copy() for k, v in _flat_tree(
                    step_trainer.model.params_tree()).items()})
    ids, bg = step_trainer._draw_batch(None)
    seeds = (step_trainer.next_seed(), step_trainer.next_seed())
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    logs = step_trainer.train_step(ids, bg, *seeds)
    torch.cuda.synchronize()
    report = {'step_launches': {k: fn.launches for k, fn in
                                wrappers.items()}}
    print(f'phase 20b rank {rank}: stepped', flush=True)
    if rank == 0:
        grads = params_to_numpy({k: p.grad for k, p in
                                 step_trainer.model.module.named_parameters()})
        np.savez(out / 'step_result.npz', ids=ids.cpu().numpy(),
                 bg=bg.cpu().numpy(), seeds=np.asarray(seeds, np.int64),
                 total=float(logs['total']),
                 num_samples=int(logs['num_samples']),
                 **{f'g_{k}': v for k, v in _flat_tree(grads).items()},
                 **{f'p_{k}': v.copy() for k, v in _flat_tree(
                     step_trainer.model.params_tree()).items()})
    params = list(step_trainer.model.module.parameters())
    for _ in range(3):
        all_reduce_grads(params, ctx.world_size)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(20):
        all_reduce_grads(params, ctx.world_size)
    torch.cuda.synchronize()
    report['allreduce_ms'] = (time.perf_counter() - start) / 20 * 1e3
    report['grad_floats'] = sum(p.numel() for p in params)
    del step_trainer, dataset

    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    result = train.main(argv)
    torch.cuda.synchronize()
    trainer = result['trainer']
    state = [p.detach().cpu().numpy().tobytes()
             for p in trainer.model.module.parameters()]
    state.append(trainer.model.buffers['density_grid'].cpu().numpy()
                 .tobytes())
    report.update(
        launches={k: fn.launches for k, fn in wrappers.items()},
        step_ms=trainer.timers['training_iteration'].mean * 1e3,
        render_s=trainer.timers['_render_testset'].total,
        rank=trainer.rank, world=trainer.world_size,
        metrics=result['metrics'],
        output_dir=str(Path(trainer.output_dir).resolve()),
        digest=hashlib.sha256(b''.join(state)).hexdigest())
    (out / f'rank{rank}.json').write_text(json.dumps(report))


def _flat_tree(tree: dict) -> dict:
    """{'hash_table': a, 'mlp': [w0, w1]} -> {'hash_table': a, 'mlp.0': w0,
    'mlp.1': w1}."""
    flat = {}
    for key, value in tree.items():
        if isinstance(value, (list, tuple)):
            flat.update({f'{key}.{i}': v for i, v in enumerate(value)})
        else:
            flat[key] = value
    return flat


def phase20_one_process_step(card: str, result: Path) -> None:
    """The two-shard step of ``dp_rank`` in this process: the same initial
    parameters, grid, ids, background and seeds, each shard's
    ``loss_and_grads`` in turn with its rank's folded seeds, the gradients
    averaged, then the trainer's Adam update; held to the ranks' step."""
    import numpy as np
    import torch

    from nerficg_torch.core.config import load_config
    from nerficg_torch.core.registry import Datasets, Methods
    from nerficg_torch.parallel.data_parallel import fold_seed
    init = dict(np.load(result / 'step_init.npz'))
    got = dict(np.load(result / 'step_result.npz'))
    run_dir = Path(json.loads((result / 'rank0.json').read_text())
                   ['output_dir'])
    config = load_config(str(run_dir / 'training_config.yaml'))
    config.MODEL.STOCHASTIC_CORNERS = 0
    config.GLOBAL.NUM_DEVICES = 1
    one = Methods.get_training_instance(config, device='cuda')
    tree = one.model.params_tree()
    for key, value in list(tree.items()):
        tree[key] = [init[f'p_{key}.{i}'] for i in range(len(value))] \
            if isinstance(value, (list, tuple)) else init[f'p_{key}']
    one.model.load_params_tree(tree)
    one.model.buffers['density_grid'] = torch.from_numpy(
        init['grid']).cuda()
    one._init_samplers(Datasets.get_dataset(config))
    # The two-shard step's sample budget is the whole batch's.
    one.num_devices = DP_RANKS
    ids = torch.from_numpy(got['ids']).cuda()
    bg = torch.from_numpy(got['bg']).cuda()
    local = ids.shape[0] // DP_RANKS
    sums, totals = None, []
    for r in range(DP_RANKS):
        logs = one.loss_and_grads(ids[r * local:(r + 1) * local], bg,
                                  *(fold_seed(int(s), r)
                                    for s in got['seeds']))
        totals.append(float(logs['total']))
        grads = [p.grad.clone() for p in one.model.module.parameters()]
        sums = grads if sums is None else [a + b for a, b in zip(sums,
                                                                 grads)]
    for p, g in zip(one.model.module.parameters(), sums):
        p.grad = g / DP_RANKS
    from nerficg_torch.methods.instant_ngp.convert import params_to_numpy
    want_grads = _flat_tree(params_to_numpy({
        k: p.grad for k, p in one.model.module.named_parameters()}))
    one.apply_update()
    want_params = _flat_tree(one.model.params_tree())
    loss = sum(totals) / DP_RANKS
    loss_err = abs(float(got['total']) - loss) / abs(loss)
    worst = {}
    for prefix, want in (('g', want_grads), ('p', want_params)):
        for key, w in want.items():
            norm = max(float(np.linalg.norm(w)), 1e-30)
            worst[f'{prefix}_{key}'] = float(
                np.linalg.norm(got[f'{prefix}_{key}'] - w)) / norm
    grad_err = max(v for k, v in worst.items() if k.startswith('g_'))
    param_err = max(v for k, v in worst.items() if k.startswith('p_'))
    print(f'phase 20b: one two-shard step, exact corners, on the card: loss '
          f'{float(got["total"]):.6f} against one process\'s {loss:.6f} '
          f'({loss_err:.2e} relative, limit {DP_LOSS_RTOL:g}); gradients '
          f'within {grad_err:.2e}, parameters after Adam within '
          f'{param_err:.2e} relative Frobenius (limit {DP_FROBENIUS_RTOL:g})'
          f'; {int(got["num_samples"])} samples over both ranks [{card}]',
          flush=True)
    if not (loss_err <= DP_LOSS_RTOL and grad_err <= DP_FROBENIUS_RTOL and
            param_err <= DP_FROBENIUS_RTOL):
        fail(f'phase 20b: the two-rank step differs from the one-process '
             f'step: {worst}')


def phase20_ranks(card: str, scene: Path, phase5_psnr: float,
                  tmp: Path) -> dict:
    """(b) configs/ingp_e2e_bench.yaml on phase 5's scene for
    DP_ITERATIONS iterations over DP_RANKS ranks of one gloo group on the
    one card, started as a user starts them (``python -m
    torch.distributed.run --standalone --nproc_per_node 2``, each rank
    ``train.main`` through ``dp_rank``): rank 0 alone wrote one run
    directory, final.ckpt loads, parameters and grid bit-equal on every
    rank, every rank's test metrics rank 0's (the test set is rendered
    over the ranks), test PSNR within DP_PSNR_BAND_DB of phase 5's, every rank
    launched the path's kernels; then the two-shard step against one
    process. Returns the kernel launches of both ranks' training runs and
    step, summed, and the number of gradient floats."""
    import os

    import numpy as np

    from nerficg_torch.core.registry import Methods
    from nerficg_torch.core.config import load_config
    result = tmp / 'ranks'
    result.mkdir()
    work = tmp / 'work'
    work.mkdir()
    argv = ['-c', str(ROOT / 'configs' / 'ingp_e2e_bench.yaml'),
            f'DATASET.PATH={scene}', 'TRAINING.RENDER_TESTSET=True',
            f'TRAINING.NUM_ITERATIONS={DP_ITERATIONS}',
            f'GLOBAL.NUM_DEVICES={DP_RANKS}',
            'TRAINING.MODEL_NAME=chip_smoke_dp']
    env = {k: v for k, v in os.environ.items()
           if k not in ('WORLD_SIZE', 'RANK', 'LOCAL_RANK', 'MASTER_ADDR',
                        'MASTER_PORT')}
    env.update(PYTHONUNBUFFERED='1', PYTHONPATH=str(ROOT))
    start = time.perf_counter()
    log = tmp / 'ranks.log'
    with open(log, 'w') as out:
        try:
            code = subprocess.run(
                [sys.executable, '-m', 'torch.distributed.run',
                 '--standalone', '--nproc_per_node', str(DP_RANKS),
                 str(ROOT / 'chip_smoke.py'), '--dp-rank', json.dumps(argv),
                 str(result)], cwd=work, env=env, stdout=out,
                stderr=subprocess.STDOUT, timeout=240).returncode
        except subprocess.TimeoutExpired:
            code = 'a timeout after 240 s'
    wall = time.perf_counter() - start
    if code != 0:
        print(log.read_text()[-8000:])
        fail(f'phase 20b: torch.distributed.run ended with {code}')
    reports = [json.loads((result / f'rank{r}.json').read_text())
               for r in range(DP_RANKS)]
    runs = list((work / 'output' / 'InstantNGPModel').iterdir())
    if len(runs) != 1 or any(r['output_dir'] != str(runs[0].resolve())
                             for r in reports):
        fail(f'phase 20b: run directories {runs}, not rank 0\'s one')
    model = Methods.get_model(load_config(str(runs[0] /
                                              'training_config.yaml')),
                              checkpoint=str(runs[0] / 'checkpoints' /
                                             'final.ckpt'), device='cuda')
    psnr = float(reports[0]['metrics']['PSNR'])
    trained = ('hash_window_fwd_stoch', 'hash_window_bwd_cached',
               'block_probe_xyz', 'seg_gather', 'seg_scatter_add')
    stepped = ('hash_window_fwd', 'hash_window_bwd', 'block_probe_xyz',
               'seg_gather', 'seg_scatter_add')
    for r, report in enumerate(reports):
        print(f'phase 20b: rank {r} of {report["world"]}: '
              f'{report["step_ms"]:.2f} ms per training_iteration, '
              f'all-reduce of the {report["grad_floats"]:,} gradient floats '
              f'over gloo (host-staged) {report["allreduce_ms"]:.3f} ms, '
              f'parameters and grid bit-equal to rank 0\'s: '
              f'{report["digest"] == reports[0]["digest"]}; its share of '
              f'the test render {report["render_s"]:.2f} s; launches '
              f'training '
              f'{ {k: report["launches"][k] for k in trained} }, the step '
              f'{ {k: report["step_launches"][k] for k in stepped} } '
              f'[{card}]')
        missing = [k for k in trained if report['launches'][k] <= 0] + \
            [k for k in stepped if report['step_launches'][k] <= 0]
        if missing:
            fail(f'phase 20b: rank {r} never launched {missing}')
        if report['digest'] != reports[0]['digest']:
            fail(f'phase 20b: rank {r}\'s parameters or grid differ from '
                 f'rank 0\'s')
        if report['metrics'] != reports[0]['metrics']:
            fail(f'phase 20b: rank {r}\'s test metrics {report["metrics"]} '
                 f'are not rank 0\'s')
        probe_only(report['launches'], f'phase 20b rank {r}')
    print(f'phase 20b: {DP_RANKS} ranks over gloo on one card, '
          f'{DP_ITERATIONS} iterations: whole run {wall:.1f} s; test '
          f'metrics ' + ', '.join(f'{k}={v:.4f}' for k, v in
                                  reports[0]['metrics'].items())
          + f' (phase 5, one process: {phase5_psnr:.3f} dB; band '
          f'{DP_PSNR_BAND_DB:g} dB); final.ckpt loads '
          f'({model.num_iterations_trained} iterations) [{card}]',
          flush=True)
    if not (np.isfinite(psnr) and abs(psnr - phase5_psnr) <=
            DP_PSNR_BAND_DB):
        fail(f'phase 20b: test PSNR {psnr:.3f} dB is not within '
             f'{DP_PSNR_BAND_DB} dB of phase 5\'s {phase5_psnr:.3f} dB')
    if model.num_iterations_trained != DP_ITERATIONS:
        fail('phase 20b: final.ckpt does not hold the trained iterations')
    phase20_one_process_step(card, result)
    launches = collections.Counter()
    for report in reports:
        launches.update(report['launches'])
        launches.update(report['step_launches'])
    return dict(launches), reports[0]['grad_floats']


def phase20_nccl(card: str, tmp: Path, numel: int) -> None:
    """(c) NCCL, the backend of ranks with a card each, at world size 1 on
    cuda:0: the all-reduce of a buffer of ``numel`` floats (the gradient
    buffer of phase 20b) leaves it as it was, and its ms."""
    import datetime

    import torch
    import torch.distributed as dist
    dist.init_process_group('nccl', init_method=f'file://{tmp / "nccl"}',
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        buf = torch.randn(numel, device='cuda:0')
        want = buf.clone()
        for _ in range(3):
            dist.all_reduce(buf)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(20):
            dist.all_reduce(buf)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - start) / 20 * 1e3
        same = torch.equal(buf, want)
    finally:
        dist.destroy_process_group()
    print(f'phase 20c: NCCL at world size 1 on cuda:0: all-reduce of '
          f'{buf.numel():,} floats {ms:.3f} ms, the buffer unchanged: '
          f'{same} [{card}]', flush=True)
    if not same:
        fail('phase 20c: a one-rank NCCL all-reduce changed the buffer')


def phase20(card: str, scene: Path, phase5_psnr: float) -> dict:
    """The decoder, two ranks on the card, NCCL; returns the ranks'
    kernel launches."""
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_dp_') as tmp:
        tmp = Path(tmp)
        (tmp / 'decode').mkdir()
        phase20_decoder(card, tmp / 'decode')
        launches, grad_floats = phase20_ranks(card, scene, phase5_psnr, tmp)
        phase20_nccl(card, tmp, grad_floats)
    print(f'phase 20: the phase took {time.perf_counter() - start:.1f} s '
          f'[{card}]', flush=True)
    return launches


def _run_dir(work: Path, method: str) -> Path:
    """The trained run ('chip_smoke_*') that a phase left under ``work``."""
    return next((work / 'output' / method).glob('chip_smoke_*'))


def main_paths(card: str) -> dict:
    """Phases 3-11 and 14-17, the methods' serving and training paths and
    the viewer; the kernels' launch counts (#15 and #16: phases 8, 9, 16
    and 17 summed)."""
    from nerficg_torch.data.synthetic import (make_dynamic_textured_scene,
                                              make_textured_scene)
    with fwd_sizes('phase 3 (window Instant-NGP served)'):
        launches = phase3_main_path(card)
    with fwd_sizes('phase 4 (one exact window step)'):
        launches.update(phase4_training_step(card))
    marcher = ('block_probe_xyz', 'seg_gather', 'seg_scatter_add')
    with tempfile.TemporaryDirectory(prefix='chip_smoke_scene_') as tmp:
        start = time.perf_counter()
        scene = make_textured_scene(Path(tmp) / 'scene', image_size=400,
                                    n_train=30, n_test=4)
        print(f'phases 5-9: 400x400 textured scene (30 train, 4 test views) '
              f'written in {time.perf_counter() - start:.1f} s', flush=True)
        # Phase 5's and 16's run directories stay for phase 17's viewers.
        kept = Path(tmp) / 'kept'
        with fwd_sizes('phase 5 (window Instant-NGP, trained and '
                       'served)'):
            phase5 = phase_training(
                card, 5, scene, 'ingp_e2e_bench.yaml', (),
                ('hash_window_fwd_stoch', 'hash_window_bwd_cached',
                 *marcher), work=kept / 'phase5')
        launches.update({k: phase5[k] for k in ('hash_window_fwd_stoch',
                                                'hash_window_bwd_cached')})
        # The same config trained with exact corners, the JAX model's
        # documented exact mode: #1 exact and #2 once per step (#2's
        # level-resident kernel is the profile's *PositionCorners*).
        with fwd_sizes('phase 5x (exact window Instant-NGP, trained)'):
            phase5x = phase_training(
                card, '5x', scene, 'ingp_e2e_bench.yaml',
                ('MODEL.STOCHASTIC_CORNERS=0',),
                ('hash_window_fwd', 'hash_window_bwd', *marcher),
                profile_share='PositionCorners',
                psnr_before=phase5['untrained_psnr'])
        for name in ('hash_window_fwd', 'hash_window_bwd'):
            launches[name] += phase5x[name]
        # The parity config at its 2^19 table; its lego scene is not in the
        # repository and its box half-extent 0.5 would clip the textured
        # scene, so the scene and MODEL.SCALE are set on the command line.
        # Departure: its occupancy threshold (alpha 0.01 per mean step) is,
        # as published (SCALE 0.5, 512 steps per ray), a density of 2.96,
        # and 1.48 at SCALE 1.0, both above the untrained field's density
        # of ~1: the warm-up grid would stay empty and nothing would train
        # from random weights (tests/test_torch_backends.py). 256 steps,
        # bench.py's pairing with SCALE 1.0 on this scene, give 0.74, a
        # quarter of the published threshold.
        with fwd_sizes('phase 6 (cell Instant-NGP, trained and served)'):
            phase6 = phase_training(
                card, 6, scene, 'ingp_parity.yaml',
                ('MODEL.SCALE=1.0', 'RENDERER.MAX_SAMPLES=256'),
                ('hash_cell_fwd', 'hash_cell_bwd', *marcher),
                ('hash_cell_fwd', *marcher), fps=False)
        launches.update({k: phase6[k] for k in ('hash_cell_fwd',
                                                'hash_cell_bwd')})
        with fwd_sizes('phase 7 (crossbar Instant-NGP, trained and '
                            'served)'):
            phase7 = phase_training(
                card, 7, scene, 'ingp_e2e_bench.yaml',
                ('MODEL.ENCODING_BACKEND=xbar',),
                ('hash_xbar_fwd', 'hash_xbar_bwd', *marcher),
                ('hash_xbar_fwd', *marcher), fps=False)
        launches.update({k: phase7[k] for k in ('hash_xbar_fwd',
                                                'hash_xbar_bwd')})
        served = phase8_gs_serving(card, scene)
        launches.update(phase9_gs_training(card, scene))
        launches['gs_composite_fwd_packed'] += \
            served['gs_composite_fwd_packed']
        for name, count in phase16_capture(card, scene,
                                           work=kept / 'phase16').items():
            launches[name] += count
        # The data layer: a Colmap capture with two cameras and Ricoh360
        # panoramas, Instant-NGP's e2e config trained and served on each.
        with fwd_sizes('phase 18 (window Instant-NGP on two cameras and on '
                       'panoramas, trained and served)'):
            for name, count in phase18_data_layer(card, scene).items():
                launches[name] = launches.get(name, 0) + count
        # The dense probe: the e2e config with PROBE_MODE 'dense', the
        # skip grid as (2, 512, 128) bitfields probed through xbar_gather
        # (#4's generic entry), never through the block probes.
        with fwd_sizes('phase 15 (window Instant-NGP, dense probe, trained '
                       'and served)'):
            phase15 = phase_training(
                card, 15, scene, 'ingp_e2e_bench.yaml',
                ('RENDERER.PROBE_MODE=dense',),
                ('hash_window_fwd_stoch', 'hash_window_bwd_cached',
                 'xbar_gather', 'seg_gather', 'seg_scatter_add'),
                ('hash_window_fwd', 'xbar_gather', 'seg_gather',
                 'seg_scatter_add'), probe='xbar_gather', fps=False)
        launches['xbar_gather'] = phase15['xbar_gather']
        phase14_nerf(card, scene)
        # The viewers: #1 exact, #4, #6 and #7 serve Instant-NGP, the
        # packed #15 serves 3DGS, and #15 and #16 train it under the GUI.
        for name, count in phase17_viewer(
                card, scene,
                _run_dir(kept / 'phase5', 'InstantNGPModel'),
                _run_dir(kept / 'phase16', 'GaussianSplattingModel')).items():
            if name in launches:
                launches[name] += count
        # Ray-parallel training: two ranks on the card, held to phase 5.
        for name, count in phase20(card, scene,
                                   phase5['test_psnr']).items():
            launches[name] = launches.get(name, 0) + count
    phase10_gs_step(card)
    with tempfile.TemporaryDirectory(prefix='chip_smoke_dynamic_') as tmp:
        start = time.perf_counter()
        scene = make_dynamic_textured_scene(Path(tmp) / 'scene',
                                            image_size=400, n_train=40,
                                            n_test=4)
        print(f'phase 11: 400x400 dynamic textured scene (40 train, 4 test '
              f'views) written in {time.perf_counter() - start:.1f} s',
              flush=True)
        dnerf = phase11_dnerf(card, scene)
        for name in ('hash_xbar_fwd', 'hash_xbar_bwd'):
            launches[name] += dnerf.pop(name)
        launches.update(dnerf)
    return launches


def main() -> None:
    import torch
    start = time.perf_counter()
    card = phase0_environment()
    window_global_lib = phase1_build(card)
    report = phase2_kernels(card, window_global_lib)
    print(f'phases 0-2 took {time.perf_counter() - start:.1f} s', flush=True)
    with seg_scatter_shapes() as shapes:
        launches = main_paths(card)
    print_seg_scatter_shapes(shapes)
    phase12_dnerf_step(card)
    launches.update(phase13_op_api(card))
    print_fwd_sizes()
    phase19_tools(card)
    print(f'every phase passed in {time.perf_counter() - start:.1f} s '
          f'[{card}]', flush=True)
    kernels = [{'name': name, 'route': route, 'source': source,
                'replaces': replaces, 'launches': launches[name],
                **report[name]}
               for name, (route, source, replaces) in KERNELS.items()]
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    if sys.argv[1:2] == ['--dp-rank']:
        dp_rank(*sys.argv[2:])
    else:
        main()
