"""Device milliseconds per served frame of the rasterizer
(``rasterize_gaussians``: rect cover, cull, the packed sort, segments,
tile assembly), without the compositor's kernel."""

LAYER = 'rasterizer'
UNIT = 'ms/frame'
SOURCE = 'device_trace'
BETTER = 'lower'
MOVES = 'render_fps'
WORKLOADS = ['gs360_render_1080p']


def read(ctx):
    s = ctx.trace.layer_s('rasterizer')
    return None if s is None or not ctx.units else 1e3 * s / len(ctx.units)
