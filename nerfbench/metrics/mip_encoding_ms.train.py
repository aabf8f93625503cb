"""Device milliseconds per Mip-NeRF 360 training step of the encoding
(``MipNeRF360Renderer.encode``: conical-frustum Gaussians, the
contraction and its Jacobian, the integrated positional encoding) of
every round's samples."""

LAYER = 'encoding'
UNIT = 'ms/step'
SOURCE = 'device_trace'
BETTER = 'lower'
MOVES = 'train_it_per_s'
WORKLOADS = ['mip360_train']


def read(ctx):
    s = ctx.trace.layer_s('encoding')
    return None if s is None or not ctx.units else 1e3 * s / len(ctx.units)
