"""Mip-NeRF 360 method plugin (Barron et al., CVPR 2022)."""

from nerficg_torch.core.registry import register_method
from nerficg_torch.methods.mipnerf360.model import MipNeRF360Model
from nerficg_torch.methods.mipnerf360.renderer import MipNeRF360Renderer
from nerficg_torch.methods.mipnerf360.trainer import MipNeRF360Trainer

MODEL = MipNeRF360Model
RENDERER = MipNeRF360Renderer
TRAINER = MipNeRF360Trainer

register_method('MipNeRF360', MipNeRF360Model, MipNeRF360Renderer,
                MipNeRF360Trainer)
