"""The whole training step's share of the card's peak: the window's
FLOPs (the method's formula in ``roofline.py`` / its adapter, per step)
over the traced window's time and the configuration's peak (bf16 dense
for NeRF's GEMMs, f32 SIMT for 3DGS)."""

LAYER = 'whole step'
UNIT = '%'
SOURCE = 'device_trace'
BETTER = 'higher'
MOVES = 'train_it_per_s'
WORKLOADS = ['gs360_train', 'nerf_train']


def read(ctx):
    if not ctx.units or ctx.trace.window_s <= 0:
        return None
    flops = sum(w['flops'] for w in ctx.work())
    return 100.0 * flops / ctx.trace.window_s / ctx.peak_flops
