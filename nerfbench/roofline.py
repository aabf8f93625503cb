"""Peaks of the card and the work of a step or a frame: the arithmetic the
roofline and MFU metrics divide by.

Peaks are the published ones of one NVIDIA H100 SXM (NVIDIA's data sheet,
dense rates) at its 700 W limit; a run records the card's power limit
beside its numbers. A kernel's bound is the larger of the bytes it must
move (each input read once, each output written once) at the HBM rate and
its operations at the pipe's rate; the compositor's operations are counted
per (entry, pixel) pair whose alpha passes 1/255, 27 forward and 68
backward (PERF.md, section 2), with one ``expf`` per such pair on the
special-function units.
"""

from __future__ import annotations

__all__ = ['HBM_BYTES_PER_S', 'F32_OPS_PER_S', 'SFU_OPS_PER_S',
           'BF16_TENSOR_FLOPS', 'PEAKS', 'bound_s', 'gs_composite_fwd',
           'gs_composite_bwd', 'gs_step_flops', 'gs_frame_flops',
           'GS_FWD_OPS', 'GS_BWD_OPS']

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# ex2 for expf: 16 per clock per SM x 132 SMs x 1.98 GHz boost.
SFU_OPS_PER_S = 16 * 132 * 1.98e9
BF16_TENSOR_FLOPS = 989e12
PEAKS = {'f32_simt': F32_OPS_PER_S, 'bf16_dense': BF16_TENSOR_FLOPS}

GS_FWD_OPS = 14 + 13
GS_BWD_OPS = 14 + 54
P = 256                   # pixels per 16 x 16 tile
CHUNK = 32                # entries per chunk of the saved transmittance

# Per Gaussian, the frontend's arithmetic forward: activations (~15), the
# rotation and R S (39), the covariance (54), the view transform and
# projection (27), the Jacobian and J W (46), the 2D covariance (60), the
# conic, eigenvalue and culling tests (28), the view direction (10), the
# degree-4 SH basis (40) and colour (96), clamps (5): ~420; backward twice.
GS_FRONTEND_FWD = 420
GS_FRONTEND_BWD = 840
# Per pixel and channel: L1 (3) and SSIM's five 11 x 11 separable
# filterings (5 x 44) with its map (20): ~245 forward; backward twice.
GS_LOSS_FWD = 245
GS_LOSS_BWD = 490
# Per parameter: Adam's two moments, the bias corrections, the update.
ADAM_OPS = 12
GS_FLOATS_PER_GAUSSIAN = 59


def bound_s(nbytes: float, ops: float, sfu: float = 0.0) -> float:
    """The least seconds the card could take: bytes at the HBM rate, or
    f32 operations and special-function operations at theirs (two pipes
    that overlap), whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S,
               max(ops / F32_OPS_PER_S, sfu / SFU_OPS_PER_S))


def gs_composite_fwd(work: dict, packed: bool) -> tuple[float, float, float]:
    """(bytes, operations, expf) of one forward composite: the entries
    each tile composites (10 f32 attributes, or 5 packed words), the
    segments' starts and counts, the (T, 5, P) output and, training, the
    transmittance saved at each live chunk."""
    tiles = work['num_tiles']
    nbytes = work['entries'] * (5 if packed else 10) * 4 + tiles * 2 * 4 + \
        tiles * 5 * P * 4
    if not packed:
        nbytes += work['live_chunks'] * P * 4
    return nbytes, GS_FWD_OPS * work['passing'], work['passing']


def gs_composite_bwd(work: dict) -> tuple[float, float, float]:
    """(bytes, operations, expf) of one backward composite: the entries,
    segments, saved transmittance and d out read; d of the stream's 10
    attribute rows written over every entry of the stream."""
    tiles = work['num_tiles']
    nbytes = work['entries'] * 10 * 4 + tiles * 2 * 4 + \
        work['live_chunks'] * P * 4 + tiles * 5 * P * 4 + \
        work['stream_entries'] * 10 * 4
    return nbytes, GS_BWD_OPS * work['passing'], work['passing']


def gs_frame_flops(work: dict) -> float:
    """A served frame: the frontend over every Gaussian and the forward
    composite's pairs."""
    return work['gaussians'] * GS_FRONTEND_FWD + \
        GS_FWD_OPS * work['passing']


def gs_step_flops(work: dict) -> float:
    """A training step: the frontend forward and backward, both
    composites, the loss over the image and Adam over every parameter."""
    n = work['gaussians']
    return n * (GS_FRONTEND_FWD + GS_FRONTEND_BWD) + \
        (GS_FWD_OPS + GS_BWD_OPS) * work['passing'] + \
        work['pixels'] * 3 * (GS_LOSS_FWD + GS_LOSS_BWD) + \
        n * GS_FLOATS_PER_GAUSSIAN * ADAM_OPS
