"""Camera trajectory plugins for novel-view rendering, a port of
nerficg_tpu/visual/trajectories/ (reference: src/Visual/Trajectories/, the
plugin base utils.py:15-62 and seven implementations). Trajectories
register themselves and become extra dataset subsets that
``nerficg_torch.scripts.inference -s <name>`` renders.
"""

from nerficg_torch.visual.trajectories.base import CameraTrajectory, lemniscate_poses
from nerficg_torch.visual.trajectories import builtin  # noqa: F401  (registers)
