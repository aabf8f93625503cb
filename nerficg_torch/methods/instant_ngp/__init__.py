"""Instant-NGP method plugin (reference: src/Methods/InstantNGP/__init__.py).
The port has the model and renderer; the trainer comes with training."""

from nerficg_torch.core.registry import register_method
from nerficg_torch.methods.instant_ngp.model import InstantNGPModel
from nerficg_torch.methods.instant_ngp.renderer import InstantNGPRenderer

MODEL = InstantNGPModel
RENDERER = InstantNGPRenderer

register_method('InstantNGP', InstantNGPModel, InstantNGPRenderer)
