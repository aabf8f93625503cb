"""Share of the roofline of the training compositor, kernels #15
``gs_composite_fwd`` and #16 ``gs_composite_bwd``: the least time the
window's composites could take (``roofline.bound_s`` of each step's work,
counted by the reference's geometry) over the device time of the
compositor's calls, forward and backward."""

from nerfbench import roofline

LAYER = 'kernels'
UNIT = '%'
SOURCE = 'device_trace'
BETTER = 'higher'
MOVES = 'train_it_per_s'
WORKLOADS = ['gs360_train']


def read(ctx):
    s = ctx.trace.layer_s('composite')
    if s is None or not ctx.units:
        return None
    least = sum(roofline.bound_s(*roofline.gs_composite_fwd(w, False)) +
                roofline.bound_s(*roofline.gs_composite_bwd(w))
                for w in ctx.work())
    return 100.0 * least / s
