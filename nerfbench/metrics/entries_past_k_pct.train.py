"""Share of the training window's tile entries that the rasterizer sorts
and gathers and then drops past a tile's budget k: the program's own
counters ``gs/entries_past_k`` over ``gs/entries`` (``rasterize_gaussians``,
``nerficg_torch/core/tracing.py``), added on the card while the window is
traced and read once after it. A program without the counters reads
nothing."""

from nerfbench.reads import entries_past_k_pct

LAYER = 'rasterizer'
UNIT = '%'
SOURCE = 'program_counter'
BETTER = 'lower'
MOVES = 'train_it_per_s'
WORKLOADS = ['gs360_train']


def read(ctx):
    return entries_past_k_pct()
