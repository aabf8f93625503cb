"""Device milliseconds per training step of the optimizer's update (the
trainer's ``apply_update``: the learning rate and torch.optim.Adam)."""

LAYER = 'optimizer'
UNIT = 'ms/step'
SOURCE = 'device_trace'
BETTER = 'lower'
MOVES = 'train_it_per_s'
WORKLOADS = ['gs360_train', 'nerf_train']


def read(ctx):
    s = ctx.trace.layer_s('optimizer')
    return None if s is None or not ctx.units else 1e3 * s / len(ctx.units)
