"""The whole served frame's share of the card's f32 peak: the window's
FLOPs (frontend and forward composite, ``roofline.gs_frame_flops``) over
the traced window's time."""

LAYER = 'whole step'
UNIT = '%'
SOURCE = 'device_trace'
BETTER = 'higher'
MOVES = 'render_fps'
WORKLOADS = ['gs360_render_1080p']


def read(ctx):
    if not ctx.units or ctx.trace.window_s <= 0:
        return None
    flops = sum(w['flops'] for w in ctx.work())
    return 100.0 * flops / ctx.trace.window_s / ctx.peak_flops
