"""Device milliseconds per Mip-NeRF 360 training step of the proposal MLP
(``MipNeRF360Model.proposal_density``: the 4 x 256 trunk at both
proposal rounds' samples), forward and backward."""

LAYER = 'proposal'
UNIT = 'ms/step'
SOURCE = 'device_trace'
BETTER = 'lower'
MOVES = 'train_it_per_s'
WORKLOADS = ['mip360_train']


def read(ctx):
    s = ctx.trace.layer_s('proposal')
    return None if s is None or not ctx.units else 1e3 * s / len(ctx.units)
