"""Device milliseconds per Mip-NeRF 360 training step of the NeRF MLP
(``MipNeRF360Model.field``: the 8 x 1024 trunk's GEMMs, the bottleneck
and view branch), forward and backward."""

LAYER = 'field'
UNIT = 'ms/step'
SOURCE = 'device_trace'
BETTER = 'lower'
MOVES = 'train_it_per_s'
WORKLOADS = ['mip360_train']


def read(ctx):
    s = ctx.trace.layer_s('field')
    return None if s is None or not ctx.units else 1e3 * s / len(ctx.units)
