"""Share of the served frames' tile entries that the rasterizer sorts and
gathers and then drops past a tile's budget k, at 1080p: the program's
own counters, as ``entries_past_k_pct.train`` reads them."""

from nerfbench.reads import entries_past_k_pct

LAYER = 'rasterizer'
UNIT = '%'
SOURCE = 'program_counter'
BETTER = 'lower'
MOVES = 'render_fps'
WORKLOADS = ['gs360_render_1080p']


def read(ctx):
    return entries_past_k_pct()
