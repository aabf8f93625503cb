"""Device milliseconds per served 1080p frame of the 3DGS frontend
(``GaussianSplattingRenderer.frontend``), the ``frontend`` layer as
``frontend_ms.train`` reads it."""

LAYER = 'frontend'
UNIT = 'ms/frame'
SOURCE = 'device_trace'
BETTER = 'lower'
MOVES = 'render_fps'
WORKLOADS = ['gs360_render_1080p']


def read(ctx):
    s = ctx.trace.layer_s('frontend')
    return None if s is None or not ctx.units else 1e3 * s / len(ctx.units)
