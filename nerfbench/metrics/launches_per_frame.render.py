"""Device operations (kernels, memcpys, memsets) per served frame in the
traced window: the renderer's dispatch."""

LAYER = 'renderer'
UNIT = 'launches/frame'
SOURCE = 'device_trace'
BETTER = 'lower'
MOVES = 'render_fps'
WORKLOADS = ['gs360_render_1080p']


def read(ctx):
    n = ctx.trace.count()
    return n / len(ctx.units) if ctx.units and n else None
