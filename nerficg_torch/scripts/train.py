#!/usr/bin/env python3
"""Train a method on a dataset from a YAML config.

Port of scripts/train.py (reference: scripts/train.py:12-25). The run
directory (``output/<method>/<MODEL_NAME>_<timestamp>``) receives the
config, checkpoints/final.ckpt, the test renders with metrics_8bit.txt,
timings.txt and vram_stats.txt.

  python -m nerficg_torch.scripts.train -c configs/ingp_e2e_bench.yaml \
      [--device cpu] [KEY.SUBKEY=value ...]

It runs on the first CUDA card and refuses to start without one, unless
``--device cpu`` asks for the CPU (the kernels' plain versions).

Instant-NGP and D-NeRF train data-parallel over N processes, each started
by torchrun, the same command otherwise:

  python -m torch.distributed.run --standalone --nproc_per_node N \
      -m nerficg_torch.scripts.train -c CFG GLOBAL.NUM_DEVICES=N [--device cpu]

Each rank computes on card ``LOCAL_RANK % device_count`` (NCCL where each
has a card of its own, gloo where they share one or run on the CPU), and
rank 0 alone writes the run directory. The test set is rendered over the
ranks, and ``main`` returns the same test metrics on every rank.
"""

from __future__ import annotations

import argparse

from nerficg_torch.core.registry import Datasets, Methods
from nerficg_torch.core.setup import setup, teardown

__all__ = ['main']


def main(argv: list[str] | None = None) -> dict:
    """Returns {'trainer', 'output_dir', 'metrics'}: the trainer after its
    run, the run directory and the test-set metrics (empty without a test
    render)."""
    parser = argparse.ArgumentParser(description='train a radiance-field '
                                                 'method')
    parser.add_argument('-c', '--config', type=str, default=None,
                        help='path to YAML config file')
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                        help='cuda (default: the first card) or cpu')
    parser.add_argument('overrides', nargs='*', default=[],
                        help='KEY.SUBKEY=value config overrides')
    args = parser.parse_args(argv)
    ctx = setup(args.config, args.overrides, device=args.device)
    trainer = Methods.get_training_instance(ctx.config, device=ctx.device)
    dataset = Datasets.get_dataset(ctx.config)
    resume = ctx.config.get_path('TRAINING.LOAD_CHECKPOINT')
    if resume:
        trainer.load_training_state(resume)
    trainer.run(dataset)
    teardown(ctx)
    return {'trainer': trainer, 'output_dir': trainer.output_dir,
            'metrics': trainer.test_metrics}


if __name__ == '__main__':
    main()
