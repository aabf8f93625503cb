"""How ``correct`` is decided: the program's records against the plain
reference, each number held to its limit (``nerfbench/limits/<cell>.json``,
with the readings each limit was set from in PERF.md)."""

from __future__ import annotations

import math

import torch

__all__ = ['compare', 'judge', 'compare_frames']


def compare_frames(method, cfg: dict, traffic: dict, seed: int,
                   frames: dict, device, dtype=torch.float32) -> dict:
    """Worst frame of the sample: root-mean-square and largest absolute
    gap of its RGB to the reference's frame of the same pose."""
    poses = sorted(frames)
    rmse = worst = 0.0
    for pose, want in zip(poses, method.reference_frames(
            cfg, traffic, seed, poses, device, dtype)):
        gap = frames[pose].float().to(want.device) - want
        rmse = max(rmse, float(torch.sqrt(torch.mean(gap * gap))))
        worst = max(worst, float(gap.abs().max()))
    return {'frame_rmse': rmse if poses else math.inf,
            'frame_max_abs_gap': worst if poses else math.inf,
            'frames_compared': len(poses)}


def compare(cell, seed: int, records: dict, device) -> dict:
    """The numbers the cell's limits hold, from the program's records."""
    method = cell.method
    if cell.traffic['entry'] == 'render':
        return compare_frames(method, cell.config, cell.traffic, seed,
                              records['frames'], device)
    reference = method.reference_train(cell.config, cell.traffic, seed,
                                       records, device)
    return method.compare_train(records, reference)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): every limited number present,
    finite and at or under its limit; no limits, no correct run."""
    shown, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        good = isinstance(value, (int, float)) and math.isfinite(value) \
            and value <= limit
        ok &= good
        # A number that is not finite is printed as text: JSON has no inf.
        shown[name] = {'value': value if good or (
            isinstance(value, (int, float)) and math.isfinite(value))
            else str(value), 'limit': limit}
    return ok and bool(limits), shown
