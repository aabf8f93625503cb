"""Device milliseconds per training step of the rasterizer
(``rasterize_gaussians``: rect cover, cull, sort, segments, tile
assembly), forward and backward, without the compositor's kernels."""

LAYER = 'rasterizer'
UNIT = 'ms/step'
SOURCE = 'device_trace'
BETTER = 'lower'
MOVES = 'train_it_per_s'
WORKLOADS = ['gs360_train']


def read(ctx):
    s = ctx.trace.layer_s('rasterizer')
    return None if s is None or not ctx.units else 1e3 * s / len(ctx.units)
