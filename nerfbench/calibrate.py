"""The readings each limit of ``correct`` is set from, on the card:

    python3 -m nerfbench.calibrate --workload NAME --seeds S1 S2 ... \\
        [--control-seeds C1 C2 ...] [--seconds 2]

For every seed, in one process: the program's sound run, judged by the
reference as a run judges it (a training cell: set-up and its three
checked steps; a serving cell: set-up and a window of ``--seconds``), and
for every control seed: the control, the reference computed in the next
precision below the configuration's (its ``control_dtype``: float32 ->
bfloat16 for 3DGS; bf16 operands -> float8 e4m3 for NeRF's MLPs) put in
the program's place, and,
for a training cell, the half-batch fault planted in the reference (the
loss over half the image or half the rays). A state left unchanged reads 1
on the update gap by definition and is not run. Prints one JSON line per
reading, then the largest sound reading and the smallest control and
fault readings of each number.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from nerfbench import check
from nerfbench.spec import Cell

__all__ = ['main']

def control_dtype(cell) -> torch.dtype:
    """The precision the configuration names for its control
    (``control_dtype``: the next below the one it states)."""
    return getattr(torch, cell.config['control_dtype'])


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()


def _numbers(d: dict) -> dict:
    return {k: v for k, v in d.items() if isinstance(v, (int, float))}


def train_readings(cell, seed: int, control: bool, device) -> list[dict]:
    method = cell.method
    traffic = dict(cell.traffic, warmup_steps=3)
    run = cell.driver.Train(method, cell.config, traffic, seed, device)
    records = run.records()
    run.close()
    del run
    _free(device)
    reference = method.reference_train(cell.config, traffic, seed, records,
                                       device)
    out = [{'kind': 'program', 'seed': seed,
            **_numbers(method.compare_train(records, reference))}]
    if control:
        ctrl = method.reference_train(cell.config, traffic, seed, records,
                                      device, dtype=control_dtype(cell))
        out.append({'kind': 'control', 'seed': seed,
                    **_numbers(method.compare_train(
                        dict(ctrl, seed=records['seed']), reference))})
        half = method.reference_train(cell.config, traffic, seed, records,
                                      device, fault='half_batch')
        out.append({'kind': 'fault_half_batch', 'seed': seed,
                    **_numbers(method.compare_train(
                        dict(half, seed=records['seed']), reference))})
    _free(device)
    return out


def render_readings(cell, seed: int, control: bool, seconds: float,
                    device) -> list[dict]:
    method = cell.method
    run = cell.driver.Render(method, cell.config, cell.traffic, seed, device)
    run.window(seconds)
    frames = run.records()['frames']
    run.close()
    del run
    _free(device)
    out = [{'kind': 'program', 'seed': seed,
            **_numbers(check.compare_frames(method, cell.config, cell.traffic,
                                            seed, frames, device))}]
    if control:
        poses = sorted(frames)
        low = dict(zip(poses, (f.clone() for f in method.reference_frames(
            cell.config, cell.traffic, seed, poses, device,
            dtype=control_dtype(cell)))))
        out.append({'kind': 'control', 'seed': seed,
                    **_numbers(check.compare_frames(
                        method, cell.config, cell.traffic, seed, low,
                        device))})
    _free(device)
    return out


def summary(readings: list[dict]) -> dict:
    names = sorted({k for r in readings for k in r
                    if k not in ('kind', 'seed')})
    out = {}
    for name in names:
        by_kind: dict = {}
        for r in readings:
            if name in r:
                by_kind.setdefault(r['kind'], []).append(r[name])
        out[name] = {'program_max': max(by_kind.get('program', [0.0])),
                     **{f'{k}_min': min(v) for k, v in by_kind.items()
                        if k != 'program'}}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', type=int, nargs='+', required=True)
    parser.add_argument('--control-seeds', type=int, nargs='*', default=[])
    parser.add_argument('--seconds', type=float, default=2.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('nerfbench.calibrate: no CUDA card', file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    readings = []
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        control = seed in args.control_seeds
        if cell.traffic['entry'] == 'render':
            got = render_readings(cell, seed, control, args.seconds, 'cuda')
        else:
            got = train_readings(cell, seed, control, 'cuda')
        for r in got:
            print(json.dumps(r), flush=True)
        readings += got
    print(json.dumps({'summary': summary(readings)}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
