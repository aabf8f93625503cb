"""Vanilla NeRF method plugin (reference: src/Methods/NeRF/__init__.py)."""

from nerficg_torch.core.registry import register_method
from nerficg_torch.methods.nerf.model import NeRFModel
from nerficg_torch.methods.nerf.renderer import NeRFRenderer
from nerficg_torch.methods.nerf.trainer import NeRFTrainer

MODEL = NeRFModel
RENDERER = NeRFRenderer
TRAINER = NeRFTrainer

register_method('NeRF', NeRFModel, NeRFRenderer, NeRFTrainer)
