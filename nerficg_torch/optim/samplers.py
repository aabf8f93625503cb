"""Element, image and dataset samplers for training batches, ported from
nerficg_tpu/optim/samplers.py (reference: src/Optim/Samplers/: utils.py:
8-57, ImageSamplers.py:11-61, DatasetSamplers.py:10-77). The indices come
from numpy's ``default_rng`` in the JAX package's order, so both packages
draw the same views, pixels and rays from the same seed;
``RayPoolSampler`` gathers its rays from the port's ray pool on the pool's
device."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nerficg_torch.core.errors import SamplerError
from nerficg_torch.data.types import RayBatch

__all__ = ['SequentialSampler', 'RandomSequentialSampler',
           'IncrementalSequentialSampler', 'MultinomialImageSampler',
           'DatasetSampler', 'RayPoolSampler', 'IncrementalDatasetSampler']


class SequentialSampler:
    """Cycles 0..n-1 in order."""

    def __init__(self, num_elements: int, seed: int = 0):
        if num_elements <= 0:
            raise SamplerError('sampler needs at least one element')
        self.num_elements = num_elements
        self._pos = 0

    def get(self) -> int:
        idx = self._pos
        self._pos = (self._pos + 1) % self.num_elements
        return idx


class RandomSequentialSampler(SequentialSampler):
    """Shuffled epochs: every element once per epoch, in random order."""

    def __init__(self, num_elements: int, seed: int = 0):
        super().__init__(num_elements)
        self._rng = np.random.default_rng(seed)
        self._order = self._rng.permutation(num_elements)

    def get(self) -> int:
        idx = int(self._order[self._pos])
        self._pos += 1
        if self._pos >= self.num_elements:
            self._pos = 0
            self._order = self._rng.permutation(self.num_elements)
        return idx


class IncrementalSequentialSampler(SequentialSampler):
    """A growing window: uniform over the first ``available`` elements."""

    def __init__(self, num_elements: int, seed: int = 0, initial: int = 1):
        super().__init__(num_elements)
        self.available = min(initial, num_elements)
        self._rng = np.random.default_rng(seed)

    def grow(self, count: int = 1) -> None:
        self.available = min(self.available + count, self.num_elements)

    def get(self) -> int:
        return int(self._rng.integers(0, self.available))


class MultinomialImageSampler:
    """Importance sampling over images with an updatable pdf."""

    def __init__(self, num_elements: int, seed: int = 0):
        self.num_elements = num_elements
        self.pdf = np.ones(num_elements) / num_elements
        self._rng = np.random.default_rng(seed)

    def update_pdf(self, weights: np.ndarray) -> None:
        weights = np.maximum(np.asarray(weights, np.float64), 1e-8)
        self.pdf = weights / weights.sum()

    def get(self) -> int:
        return int(self._rng.choice(self.num_elements, p=self.pdf))


class DatasetSampler:
    """A training view, then ``num_rays`` pixel ids within it (None: the
    whole image)."""

    def __init__(self, dataset, num_rays: int | None = 1024, seed: int = 0,
                 random_views: bool = True):
        self.dataset = dataset
        self.num_rays = num_rays
        n = len(dataset.subsets['train'])
        self.view_sampler = (RandomSequentialSampler(n, seed) if random_views
                             else SequentialSampler(n, seed))
        self._rng = np.random.default_rng(seed + 1)

    def get(self) -> tuple[int, Optional[np.ndarray]]:
        """(view index, pixel ids or None for the full image)."""
        view_idx = self.view_sampler.get()
        if self.num_rays is None:
            return view_idx, None
        camera = self.dataset.subsets['train'][view_idx].camera
        pixel_ids = self._rng.integers(0, camera.width * camera.height,
                                       size=self.num_rays, dtype=np.int64)
        return view_idx, pixel_ids

    def get_view(self):
        return self.dataset.subsets['train'][self.view_sampler.get()]


class RayPoolSampler:
    """Uniform over every ray of the training split's pool
    (``dataset.precompute_rays('train', device)``); batches are gathered
    on the pool's device."""

    def __init__(self, dataset, seed: int = 0,
                 device: torch.device | str = 'cpu'):
        self.rays = dataset.precompute_rays('train', device=device).rays
        self.num_rays_total = len(self.rays)
        self._rng = np.random.default_rng(seed)

    def get(self, num_rays: int) -> RayBatch:
        ids = torch.from_numpy(self.get_ids(num_rays)).to(
            self.rays.origins.device)
        return self.rays[ids]

    def get_ids(self, num_rays: int) -> np.ndarray:
        return self._rng.integers(0, self.num_rays_total, size=num_rays,
                                  dtype=np.int64)


class IncrementalDatasetSampler(DatasetSampler):
    """``DatasetSampler`` over a growing window of views."""

    def __init__(self, dataset, num_rays: int | None = 1024, seed: int = 0):
        super().__init__(dataset, num_rays, seed)
        n = len(dataset.subsets['train'])
        self.view_sampler = IncrementalSequentialSampler(n, seed)

    def grow(self, count: int = 1) -> None:
        self.view_sampler.grow(count)
