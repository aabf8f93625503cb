"""Share of the serving window in which the card idles on gaps the
viewer's loop leaves: gaps ended by a launch outside every layer's range
(``render_image``'s glue, the closed loop between frames) or by none, as
``loop_idle_pct.train`` puts them down."""

from nerfbench.reads import loop_idle_pct

LAYER = 'renderer'
UNIT = '%'
SOURCE = 'device_trace'
BETTER = 'lower'
MOVES = 'render_fps'
WORKLOADS = ['gs360_render_1080p']


def read(ctx):
    return loop_idle_pct(ctx.trace)
