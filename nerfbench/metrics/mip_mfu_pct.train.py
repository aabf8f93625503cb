"""The whole Mip-NeRF 360 training step's share of the card's bf16 dense
peak: the window's FLOPs (the adapter's ``step_flops``: 6 x the
multiply-adds of both MLPs x the samples each evaluates, per step) over
the traced window's time."""

LAYER = 'whole step'
UNIT = '%'
SOURCE = 'device_trace'
BETTER = 'higher'
MOVES = 'train_it_per_s'
WORKLOADS = ['mip360_train']


def read(ctx):
    if not ctx.units or ctx.trace.window_s <= 0:
        return None
    flops = sum(w['flops'] for w in ctx.work())
    return 100.0 * flops / ctx.trace.window_s / ctx.peak_flops
