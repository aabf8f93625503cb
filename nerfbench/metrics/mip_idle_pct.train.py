"""Share of the Mip-NeRF 360 training window in which no operation ran on
the card: one minus the union of kernel, memcpy and memset intervals over
the traced window."""

LAYER = 'device'
UNIT = '%'
SOURCE = 'device_trace'
BETTER = 'lower'
MOVES = 'train_it_per_s'
WORKLOADS = ['mip360_train']


def read(ctx):
    if ctx.trace.window_s <= 0 or not ctx.trace.count():
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
