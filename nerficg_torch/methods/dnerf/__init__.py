"""D-NeRF method plugin: a deformation field in front of a canonical
Instant-NGP field (nerficg_tpu/methods/dnerf)."""

from nerficg_torch.core.registry import register_method
from nerficg_torch.methods.dnerf.model import DNeRFModel
from nerficg_torch.methods.dnerf.renderer import DNeRFRenderer
from nerficg_torch.methods.dnerf.trainer import DNeRFTrainer

MODEL = DNeRFModel
RENDERER = DNeRFRenderer
TRAINER = DNeRFTrainer

register_method('DNeRF', DNeRFModel, DNeRFRenderer, DNeRFTrainer)
