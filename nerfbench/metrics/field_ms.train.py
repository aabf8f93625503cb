"""Device milliseconds per training step of the NeRF field
(``NeRFModel.apply``: encodings and both MLPs' GEMMs), forward and
backward."""

LAYER = 'field'
UNIT = 'ms/step'
SOURCE = 'device_trace'
BETTER = 'lower'
MOVES = 'train_it_per_s'
WORKLOADS = ['nerf_train']


def read(ctx):
    s = ctx.trace.layer_s('field')
    return None if s is None or not ctx.units else 1e3 * s / len(ctx.units)
