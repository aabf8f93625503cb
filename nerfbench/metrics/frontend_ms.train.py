"""Device milliseconds per training step of the 3DGS frontend
(``GaussianSplattingRenderer.frontend``: covariances, EWA projection, SH
colour of every Gaussian), forward and backward: the ``frontend`` layer,
the range around that method (``nerfbench/spans/GaussianSplatting.json``),
which the program's ``frontend`` span also encloses."""

LAYER = 'frontend'
UNIT = 'ms/step'
SOURCE = 'device_trace'
BETTER = 'lower'
MOVES = 'train_it_per_s'
WORKLOADS = ['gs360_train']


def read(ctx):
    s = ctx.trace.layer_s('frontend')
    return None if s is None or not ctx.units else 1e3 * s / len(ctx.units)
