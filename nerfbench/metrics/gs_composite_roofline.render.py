"""Share of the roofline of the serving compositor, kernel #15
``gs_composite_fwd_packed``: the least time the window's composites could
take (``roofline.bound_s`` of each frame's work, counted by the
reference's geometry) over the device time of the compositor's calls."""

from nerfbench import roofline

LAYER = 'kernels'
UNIT = '%'
SOURCE = 'device_trace'
BETTER = 'higher'
MOVES = 'render_fps'
WORKLOADS = ['gs360_render_1080p']


def read(ctx):
    s = ctx.trace.layer_s('composite')
    if s is None or not ctx.units:
        return None
    least = sum(roofline.bound_s(*roofline.gs_composite_fwd(w, True))
                for w in ctx.work())
    return 100.0 * least / s
