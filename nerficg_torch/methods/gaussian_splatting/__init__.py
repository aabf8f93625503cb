"""3D Gaussian Splatting method plugin (reference:
src/Methods/GaussianSplatting/__init__.py)."""

from nerficg_torch.core.registry import register_method
from nerficg_torch.methods.gaussian_splatting.model import \
    GaussianSplattingModel
from nerficg_torch.methods.gaussian_splatting.renderer import \
    GaussianSplattingRenderer
from nerficg_torch.methods.gaussian_splatting.trainer import \
    GaussianSplattingTrainer

MODEL = GaussianSplattingModel
RENDERER = GaussianSplattingRenderer
TRAINER = GaussianSplattingTrainer

register_method('GaussianSplatting', GaussianSplattingModel,
                GaussianSplattingRenderer, GaussianSplattingTrainer)
