"""The serving entry: a viewer's closed loop over a fixed path of poses.

One client asks for the next frame as soon as the last one has arrived
(``render_image(view, benchmark=True)``, which waits for the card), cycling
the traffic's poses from the first. Set-up renders every pose once. The
window runs whole frames until ``seconds`` have passed: the rate is frames
over the time to the end of the last one, and each frame's latency is the
host's clock around its call. A sample of poses keeps the first frame the
window serves of each, for the comparison: the first pose, which every
window serves first, and the rest drawn from the seed, so that a window
too slow to reach every pose of the sample still has frames to compare
(a late frame is late, not wrong).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nerfbench.trace import WINDOW_SPAN

__all__ = ['Render', 'sampled_poses']


def sampled_poses(seed: int, poses: int, count: int) -> list[int]:
    """Pose 0 and ``count`` - 1 others drawn from the seed."""
    rng = np.random.default_rng(int(seed))
    rest = rng.choice(np.arange(1, poses), size=min(count, poses) - 1,
                      replace=False)
    return [0] + sorted(int(i) for i in rest)


class Render:

    def __init__(self, method, cfg: dict, traffic: dict, seed: int,
                 device) -> None:
        self.session = method.build_render(cfg, traffic, seed, device)
        self.views = self.session.views
        for view in self.views:
            self.session.render(view)
        self.sample = sampled_poses(seed, len(self.views),
                                    int(traffic['check_frames']))
        self.kept: dict[int, torch.Tensor] = {}

    def window(self, seconds: float) -> dict:
        from torch.profiler import record_function
        latencies, poses = [], []
        n = len(self.views)
        with record_function(WINDOW_SPAN):
            start = time.perf_counter()
            end = start
            while end - start < seconds:
                pose = len(latencies) % n
                t = time.perf_counter()
                rgb = self.session.render(self.views[pose])
                end = time.perf_counter()
                latencies.append(end - t)
                poses.append(pose)
                if pose in self.sample and pose not in self.kept:
                    self.kept[pose] = rgb
        elapsed = end - start
        lat_ms = np.asarray(latencies) * 1e3
        return {'metrics': {'render_fps': len(latencies) / elapsed,
                            'frame_ms_p95': float(np.percentile(lat_ms, 95))},
                'units': poses, 'elapsed_s': elapsed}

    def records(self) -> dict:
        return {'frames': self.kept}

    def close(self) -> None:
        self.session = self.views = None
