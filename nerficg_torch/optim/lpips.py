"""LPIPS (VGG16 trunk) from a weights file, ported from
nerficg_tpu/optim/lpips_jax.py (reference: the torchmetrics LPIPS(VGG) of
src/Methods/Base/Renderer.py:103-161 and the sweep's Trainer.py:353-395).

Both images are shifted and scaled by LPIPS's 'scaling layer' (in [-1, 1]
space), run through the VGG16 feature trunk, each block's last ReLU is
unit-normalised along channels, and the linear heads weight the squared
differences, averaged over space and summed over the five blocks:

    d(x, y) = sum_l mean_hw sum_c w_lc (phi_l(x)^ - phi_l(y)^)_c^2

The weights are the JAX package's npz, so one file serves both packages:
``conv{i}_w`` stored HWIO (converted to OIHW on load), ``conv{i}_b`` and
``lin{l}``. The file is found at ``NERFICG_LPIPS_WEIGHTS`` or at
``~/.cache/nerficg_tpu/lpips_vgg.npz``; ``save_weights_npz`` writes it from
the ``lpips`` package's VGG on a machine that has it. Without weights the
metric is NaN. The convolutions run in float32 on the inputs' device
whoever calls them: cuDNN's TF32 is off inside every call.
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ['lpips_vgg', 'vgg_features',
           'f32_convolutions', 'lpips_weights_available', 'load_weights',
           'weights_path', 'init_random_weights', 'save_weights_npz',
           'ENV_KEY', 'DEFAULT_PATH']

# VGG16's trunk: convolutions per block and their width; LPIPS taps the
# last ReLU of each block (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3).
_VGG_CFG = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))

# LPIPS's input normalisation (the 'scaling layer').
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

ENV_KEY = 'NERFICG_LPIPS_WEIGHTS'
DEFAULT_PATH = Path.home() / '.cache' / 'nerficg_tpu' / 'lpips_vgg.npz'

# The weights by (file, its mtime, device): a test-set render scores every
# view with them.
_cache: dict[tuple, dict[str, torch.Tensor]] = {}


@contextlib.contextmanager
def f32_convolutions():
    """cuDNN convolutions in float32, not TF32, inside the block."""
    previous = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = previous


def weights_path() -> Path:
    return Path(os.environ.get(ENV_KEY) or DEFAULT_PATH)


def load_weights(path: str | Path | None = None,
                 device: torch.device | str = 'cpu'
                 ) -> Optional[dict[str, torch.Tensor]]:
    """The trunk's and heads' tensors on ``device`` (convolutions OIHW),
    from ``path`` or ``weights_path()``; None without a file."""
    p = Path(path) if path is not None else weights_path()
    if not p.is_file():
        return None
    device = torch.device(device)
    key = (str(p.resolve()), p.stat().st_mtime_ns, device)
    if key not in _cache:
        params = {}
        with np.load(p) as data:
            for name in data.files:
                t = torch.as_tensor(np.asarray(data[name], np.float32))
                if name.endswith('_w'):
                    t = t.permute(3, 2, 0, 1)              # HWIO -> OIHW
                params[name] = t.contiguous().to(device)
        _cache[key] = params
    return _cache[key]


def lpips_weights_available() -> bool:
    return weights_path().is_file()


def vgg_features(params: dict, x: torch.Tensor) -> list[torch.Tensor]:
    """x (N, H, W, 3) in [-1, 1] -> the five blocks' last activations,
    each (N, C, H', W'). 3x3 convolutions pad by 1 ('SAME'); the 2x2
    max-pool between blocks drops an odd last row or column ('VALID')."""
    shift = x.new_tensor(_SHIFT)
    scale = x.new_tensor(_SCALE)
    h = ((x - shift) / scale).permute(0, 3, 1, 2)
    feats = []
    i = 0
    with f32_convolutions():
        for block, (n_convs, _) in enumerate(_VGG_CFG):
            if block:
                h = F.max_pool2d(h, 2, 2)
            for _ in range(n_convs):
                h = F.relu(F.conv2d(h, params[f'conv{i}_w'],
                                    params[f'conv{i}_b'], padding=1))
                i += 1
            feats.append(h)
    return feats


def lpips_vgg(pred, target, params: Optional[dict] = None,
              device: torch.device | str | None = None) -> float:
    """LPIPS-VGG of two (H, W, 3) images in [0, 1] (arrays or tensors), on
    ``device`` (default: a tensor's own, else the CPU); NaN without
    weights."""
    if device is None:
        device = pred.device if isinstance(pred, torch.Tensor) else 'cpu'
    if params is None:
        params = load_weights(device=device)
    if params is None:
        return float('nan')
    p = torch.as_tensor(pred, dtype=torch.float32, device=device)
    t = torch.as_tensor(target, dtype=torch.float32, device=device)
    total = p.new_zeros(())
    with torch.no_grad():
        fa = vgg_features(params, p[None] * 2.0 - 1.0)
        fb = vgg_features(params, t[None] * 2.0 - 1.0)
        for layer, (a, b) in enumerate(zip(fa, fb)):
            an = a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
            bn = b / torch.sqrt(torch.sum(b * b, dim=1, keepdim=True) + 1e-10)
            lin = params[f'lin{layer}'].view(1, -1, 1, 1)
            total += torch.mean(torch.sum((an - bn) ** 2 * lin, dim=1))
    return float(total)


def init_random_weights(seed: int = 0) -> dict[str, np.ndarray]:
    """Random weights in the npz's layout (HWIO convolutions), for tests and
    smoke runs: He-scaled normal convolutions, zero biases, heads
    |N(0, 1)| x 0.01, from numpy's ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    params = {}
    cin, i = 3, 0
    for n_convs, cout in _VGG_CFG:
        for _ in range(n_convs):
            params[f'conv{i}_w'] = (rng.standard_normal((3, 3, cin, cout))
                                    * np.sqrt(2.0 / (9 * cin))
                                    ).astype(np.float32)
            params[f'conv{i}_b'] = np.zeros((cout,), np.float32)
            cin = cout
            i += 1
    for layer, (_, cout) in enumerate(_VGG_CFG):
        params[f'lin{layer}'] = (np.abs(rng.standard_normal((cout,))) * 0.01
                                 ).astype(np.float32)
    return params


def save_weights_npz(path: str | Path) -> None:
    """Write the ``lpips`` package's VGG16 trunk and linear heads to the
    npz layout (convolutions OIHW -> HWIO). Needs the ``lpips`` package and
    its weights:
        python -c "from nerficg_torch.optim.lpips import save_weights_npz;
                   save_weights_npz('lpips_vgg.npz')"
    """
    import lpips as lpips_pkg
    model = lpips_pkg.LPIPS(net='vgg', verbose=False)
    out = {}
    i = 0
    for part in (model.net.slice1, model.net.slice2, model.net.slice3,
                 model.net.slice4, model.net.slice5):
        for module in part:
            if isinstance(module, torch.nn.Conv2d):
                out[f'conv{i}_w'] = module.weight.detach().permute(
                    2, 3, 1, 0).cpu().numpy()
                out[f'conv{i}_b'] = module.bias.detach().cpu().numpy()
                i += 1
    for layer, lin in enumerate(model.lins):
        out[f'lin{layer}'] = \
            lin.model[-1].weight.detach()[0, :, 0, 0].cpu().numpy()
    np.savez(path, **out)
