"""Device milliseconds per Mip-NeRF 360 training step of the loss
(``MipNeRF360Trainer.compute_loss``: Charbonnier, distortion and the
interlevel bound's searchsorted), forward and backward."""

LAYER = 'loss'
UNIT = 'ms/step'
SOURCE = 'device_trace'
BETTER = 'lower'
MOVES = 'train_it_per_s'
WORKLOADS = ['mip360_train']


def read(ctx):
    s = ctx.trace.layer_s('loss')
    return None if s is None or not ctx.units else 1e3 * s / len(ctx.units)
