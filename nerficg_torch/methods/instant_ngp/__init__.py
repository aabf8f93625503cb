"""Instant-NGP method plugin (reference: src/Methods/InstantNGP/__init__.py)."""

from nerficg_torch.core.registry import register_method
from nerficg_torch.methods.instant_ngp.model import InstantNGPModel
from nerficg_torch.methods.instant_ngp.renderer import InstantNGPRenderer
from nerficg_torch.methods.instant_ngp.trainer import InstantNGPTrainer

MODEL = InstantNGPModel
RENDERER = InstantNGPRenderer
TRAINER = InstantNGPTrainer

register_method('InstantNGP', InstantNGPModel, InstantNGPRenderer,
                InstantNGPTrainer)
