"""Device milliseconds per Mip-NeRF 360 training step of the resampling
(``MipNeRF360Renderer.resample``: each round's inverse CDF in s-space,
searchsorted and gathers)."""

LAYER = 'sampler'
UNIT = 'ms/step'
SOURCE = 'device_trace'
BETTER = 'lower'
MOVES = 'train_it_per_s'
WORKLOADS = ['mip360_train']


def read(ctx):
    s = ctx.trace.layer_s('sampler')
    return None if s is None or not ctx.units else 1e3 * s / len(ctx.units)
