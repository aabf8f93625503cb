"""Renderer base class: postprocessing, subset rendering and metrics.

Port of nerficg_tpu/methods/base/renderer.py (reference: src/Methods/Base/
Renderer.py:41-271). The JAX renderer shards ray batches over a device mesh
(``RenderMesh``); the port renders on the model's single device.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from nerficg_torch.core.config import ConfigNode, Configurable
from nerficg_torch.core.errors import RendererError
from nerficg_torch.core.logging import Logger
from nerficg_torch.data.io import save_image
from nerficg_torch.data.types import View
from nerficg_torch.methods.base.model import BaseModel
from nerficg_torch.optim.metrics import compute_all_metrics
from nerficg_torch.visual.colormaps import apply_color_map

__all__ = ['BaseRenderer']


class BaseRenderer(Configurable):

    # Subclasses set this to validate the model type (reference: Renderer.py:44-50).
    MODEL_CLASS: type = BaseModel

    def __init__(self, config: ConfigNode | None, model: BaseModel):
        super().__init__(config, 'RENDERER')
        if not isinstance(model, self.MODEL_CLASS):
            raise RendererError(
                f'{type(self).__name__} requires a {self.MODEL_CLASS.__name__}, '
                f'got {type(model).__name__}')
        self.model = model

    def render_image(self, view: View,
                     benchmark: bool = False) -> dict[str, torch.Tensor]:
        """Render one view -> dict of HxWxC tensors (reference:
        Renderer.py:57-71). Keys typically: rgb, depth, alpha."""
        raise NotImplementedError

    def postprocess_outputs(self, outputs: dict[str, torch.Tensor],
                            view: View) -> dict[str, np.ndarray]:
        """rgb clamp, alpha expand, depth colormap (reference: Renderer.py:73-85)."""
        result: dict[str, np.ndarray] = {}
        for key, value in outputs.items():
            if key == 'depth':
                far = min(view.camera.far, float(value.max()) + 1e-6)
                value = apply_color_map(value, 'TURBO',
                                        min_value=view.camera.near,
                                        max_value=far)
            value = value.detach().cpu().numpy()
            if key == 'rgb':
                value = np.clip(value, 0.0, 1.0)
            elif key == 'alpha':
                value = np.clip(value, 0.0, 1.0)
                if value.shape[-1] == 1:
                    value = np.repeat(value, 3, axis=-1)
            result[key] = value
        return result

    def render_subset(self, dataset, subset: str = 'test',
                      output_dir: str | Path | None = None,
                      compute_metrics: bool = True,
                      visualize_errors: bool = False) -> dict[str, float]:
        """Render a dataset split to per-output-key image dirs + metrics
        (reference: Renderer.py:206-271); with ``visualize_errors``, each
        view's L1 error map under ``error/``."""
        views = dataset.subsets[subset]
        if not views:
            Logger.warning(f'render_subset: no views in {subset!r}')
            return {}
        output_dir = None if output_dir is None else Path(output_dir)
        per_image_metrics: list[dict[str, float]] = []
        for i, view in enumerate(Logger.progress(views, desc=f'rendering {subset}')):
            processed = self.postprocess_outputs(self.render_image(view), view)
            gt = view.rgb
            if gt is not None and view.alpha_data.exists():
                # Composite GT onto the shared background so the comparison
                # matches the rendered output (reference: Renderer.py:214-226).
                alpha = view.alpha
                gt = gt[..., :3] * alpha + \
                    view.camera.background_color * (1.0 - alpha)
            if output_dir is not None:
                for key, img in processed.items():
                    save_image(img, output_dir / key / f'{i:05d}.png')
                if visualize_errors and gt is not None:
                    save_image(self.visualize_error(processed['rgb'], gt),
                               output_dir / 'error' / f'{i:05d}.png')
            if compute_metrics and gt is not None:
                # The reference's 8-bit protocol: quantize both images first
                # (Renderer.py:103-161).
                pred8 = np.round(np.clip(processed['rgb'], 0, 1) * 255) / 255
                gt8 = np.round(np.clip(gt[..., :3], 0, 1) * 255) / 255
                per_image_metrics.append(
                    compute_all_metrics(pred8, gt8, device=self.model.device))
        metrics: dict[str, float] = {}
        if per_image_metrics:
            unavailable = []
            for key in per_image_metrics[0]:
                vals = [m[key] for m in per_image_metrics]
                if np.all(np.isnan(vals)):
                    unavailable.append(key)
                    continue
                metrics[key] = float(np.nanmean(vals))
            for key in unavailable:
                Logger.warning(
                    f'metric {key!r} unavailable'
                    + (' (no LPIPS/VGG weights: set NERFICG_LPIPS_WEIGHTS, '
                       'see optim/lpips.py)' if 'lpips' in key else ''))
            if output_dir is not None:
                self._write_metrics_file(output_dir / 'metrics_8bit.txt',
                                         per_image_metrics, metrics,
                                         unavailable=unavailable)
            Logger.info(f'{subset} metrics: ' +
                        ', '.join(f'{k}={v:.4f}' for k, v in metrics.items()))
        return metrics

    @staticmethod
    def _write_metrics_file(path: Path, per_image: list[dict], mean: dict,
                            unavailable: list[str] = ()) -> None:
        """metrics_8bit.txt with a machine-parsable last line
        (reference: Renderer.py:150-161)."""
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, 'w') as f:
            for key in unavailable:
                f.write(f'# {key}: unavailable'
                        + (' (no weights file; set NERFICG_LPIPS_WEIGHTS)'
                           if 'lpips' in key else '') + '\n')
            for i, m in enumerate(per_image):
                f.write(f'{i:05d}: ' + ' '.join(f'{k}={v:.6f}' for k, v in m.items()) + '\n')
            f.write('mean: ' + ' '.join(f'{k}={v:.6f}' for k, v in mean.items()) + '\n')

    @staticmethod
    def visualize_error(pred: np.ndarray, gt: np.ndarray,
                        mode: str = 'l1') -> np.ndarray:
        """Per-pixel L1 or L2 error through the INFERNO colormap, scaled to
        the largest error (reference: Renderer.py:163-204)."""
        diff = np.asarray(pred, np.float32) - np.asarray(gt[..., :3],
                                                         np.float32)
        err = np.abs(diff).mean(-1) if mode == 'l1' else (diff ** 2).mean(-1)
        return apply_color_map(torch.from_numpy(err), 'INFERNO',
                               min_value=0.0,
                               max_value=max(float(err.max()), 1e-6)).numpy()
