"""Share of the window's NeRF samples whose frustum mean lies outside the
unit ball, where the contraction bends it: the program's counter
``mip/contracted`` (``MipNeRF360Renderer._render_rays_impl``, added on the
card while the window is traced) over the window's NeRF samples (the
adapter's ``train_work``). A program without the counter reads nothing."""

from nerfbench.reads import program_counters

LAYER = 'encoding'
UNIT = '%'
SOURCE = 'program_counter'
BETTER = 'lower'
MOVES = 'train_it_per_s'
WORKLOADS = ['mip360_train']


def read(ctx):
    contracted = (program_counters() or {}).get('mip/contracted')
    if contracted is None or not ctx.units:
        return None
    samples = sum(w['nerf_samples'] for w in ctx.work())
    return 100.0 * contracted / samples if samples else None
