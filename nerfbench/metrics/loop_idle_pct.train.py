"""Share of the training window in which the card idles on gaps the loop
leaves: each idle gap is put down to the device operation that ends it,
and these are the gaps ended by a launch outside every layer's range (the
callbacks, the trainer's copies and glue) or by none (``reads.py``
``loop_idle_pct``). The rest of ``device_idle_pct.train`` is the layers'
own host time."""

from nerfbench.reads import loop_idle_pct

LAYER = 'trainer loop and dispatch'
UNIT = '%'
SOURCE = 'device_trace'
BETTER = 'lower'
MOVES = 'train_it_per_s'
WORKLOADS = ['gs360_train', 'nerf_train']


def read(ctx):
    return loop_idle_pct(ctx.trace)
