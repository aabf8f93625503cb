"""Device operations (kernels, memcpys, memsets) the host issued per
training iteration in the traced window: the trainer loop's dispatch."""

LAYER = 'trainer loop and dispatch'
UNIT = 'launches/step'
SOURCE = 'device_trace'
BETTER = 'lower'
MOVES = 'train_it_per_s'
WORKLOADS = ['gs360_train', 'nerf_train']


def read(ctx):
    n = ctx.trace.count()
    return n / len(ctx.units) if ctx.units and n else None
