"""The benchmark's inputs, made from ``--seed``: poses, images, 3D Gaussians
and MLP weights.

Everything here is the yardstick's own: the program under test receives
what these functions make, and the plain reference (``nerfbench/reference``)
makes the same again from the same seed. Tensors are made on the device
with a ``torch.Generator`` seeded from (seed, stream name), in a few large
calls, so any one leaf can be made again alone. Poses do not depend on the
seed: every seed gets the same geometry and the same work, and only the
realisation of the Gaussians, the images and the weights changes.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

__all__ = ['generator', 'look_at', 'ring_poses', 'ellipse_poses',
           'image_params', 'images', 'gaussian_leaf', 'GAUSSIAN_LEAVES',
           'mlp_leaves', 'mlp_weights', 'pinhole_directions']


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A generator on ``device`` for one named stream of one seed."""
    digest = hashlib.sha256(f'{int(seed)}/{stream}'.encode()).digest()
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(digest[:8], 'little') >> 1)


# -- poses -------------------------------------------------------------------

def look_at(eye, target=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """(4, 4) camera-to-world in the OpenCV convention (x right, y down,
    z forward) of a camera at ``eye`` looking at ``target``; world z up."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = (
        right, np.cross(fwd, right), fwd, eye)
    return c2w


def ring_poses(count: int, radius: float, height: float,
               height_swing: float) -> list[np.ndarray]:
    """Inward-facing poses on a ring, as a hand-held 360-degree capture
    walks it: evenly spaced, the height rising and falling twice a turn."""
    poses = []
    for i in range(count):
        a = 2.0 * math.pi * i / count
        z = height + height_swing * math.sin(2.0 * a)
        poses.append(look_at((radius * math.cos(a), radius * math.sin(a), z)))
    return poses


def ellipse_poses(count: int, semi_x: float, semi_y: float, height: float,
                  height_swing: float) -> list[np.ndarray]:
    """A closed elliptical path of ``count`` poses around the origin, each
    looking at it (the viewer's orbit of a served scene)."""
    poses = []
    for i in range(count):
        a = 2.0 * math.pi * i / count
        z = height + height_swing * math.sin(a)
        poses.append(look_at((semi_x * math.cos(a), semi_y * math.sin(a), z)))
    return poses


def pinhole_directions(width: int, height: int, focal: float,
                       device) -> torch.Tensor:
    """(H*W, 3) camera-space directions through the pixel centres, row
    major, at depth 1 (principal point at the image centre)."""
    x = (torch.arange(width, dtype=torch.float32, device=device) + 0.5
         - width / 2.0) / focal
    y = (torch.arange(height, dtype=torch.float32, device=device) + 0.5
         - height / 2.0) / focal
    yy, xx = torch.meshgrid(y, x, indexing='ij')
    return torch.stack([xx.reshape(-1), yy.reshape(-1),
                        torch.ones_like(xx).reshape(-1)], -1)


# -- images ------------------------------------------------------------------

_IMAGE_PARAMS = 16


def image_params(seed: int, count: int, device) -> torch.Tensor:
    """(count, 16) uniform parameters of the procedural images, one call."""
    return torch.rand((count, _IMAGE_PARAMS),
                      generator=generator(seed, 'images', device),
                      device=device)


def images(params: torch.Tensor, width: int, height: int,
           alpha: bool) -> torch.Tensor:
    """(V, H, W, 3 or 4) float32 images in [0, 1]: per channel a sum of two
    oriented sinusoids of 2-40 cycles an image, and with ``alpha`` a soft
    elliptical silhouette (an object on an empty background, as in
    NeRF-Synthetic). Elementwise from the parameters, so the same
    parameters give the same bits on one device."""
    device = params.device
    y = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) \
        / height
    x = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) \
        / width
    yy, xx = torch.meshgrid(y, x, indexing='ij')
    p = params[:, :, None, None]
    chans = []
    for c in range(3):
        f1 = 2.0 + 38.0 * p[:, 2 * c]
        f2 = 2.0 + 38.0 * p[:, 2 * c + 1]
        phase = 6.2831853 * p[:, 6 + c]
        wave = torch.sin(f1 * xx + phase) + torch.cos(f2 * yy - phase) \
            + 0.5 * torch.sin((f1 + f2) * (xx + yy))
        chans.append(0.5 + 0.2 * wave)
    out = [torch.stack(chans, -1).clamp_(0.0, 1.0)]
    if alpha:
        cx = 0.35 + 0.3 * p[:, 9]
        cy = 0.35 + 0.3 * p[:, 10]
        rx = 0.2 + 0.15 * p[:, 11]
        ry = 0.2 + 0.15 * p[:, 12]
        r = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2
        out.append(torch.sigmoid(12.0 * (1.0 - r))[..., None])
    return torch.cat(out, -1)


# -- 3D Gaussians ------------------------------------------------------------

# The model's raw parameter leaves, in the order they are made.
GAUSSIAN_LEAVES = ('positions', 'features_dc', 'features_rest', 'scales',
                   'rotations', 'opacities')


def _split(count: int, shares: tuple[float, ...]) -> list[int]:
    sizes = [int(count * s) for s in shares[:-1]]
    return sizes + [count - sum(sizes)]


def gaussian_leaf(name: str, seed: int, spec: dict, device) -> torch.Tensor:
    """One raw parameter leaf of the procedural capture, in the model's
    layout (``GaussianSplattingModel``: raw positions, SH features DC and
    rest, log scales, wxyz quaternions, logit opacities), float32.

    ``spec`` is the configuration's ``scene`` block: ``count`` Gaussians in
    three groups, as an unbounded 360-degree capture holds them: an object
    (``object_share``) normal around the origin, a ground disk below it
    (``ground_share``) denser towards its centre, and a far background
    shell (the rest) in the upper hemisphere. Scales are log-normal per
    axis around each group's median (the shell's grows with distance),
    opacities logit-normal, SH colours normal with small higher bands."""
    n = int(spec['count'])
    gen = generator(seed, f'gaussians/{name}', device)
    n_obj, n_ground, n_bg = _split(n, (spec['object_share'],
                                       spec['ground_share'], 1.0))

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    if name == 'positions':
        obj = randn(n_obj, 3) * spec['object_sigma']
        obj = obj * torch.clamp(spec['object_radius'] / torch.linalg.norm(
            obj, dim=-1, keepdim=True).clamp(min=1e-6), max=1.0)
        u = rand(n_ground, 3)
        r = spec['ground_radius'] * u[:, 0] ** 1.5
        a = 6.2831853 * u[:, 1]
        ground = torch.stack([r * torch.cos(a), r * torch.sin(a),
                              spec['ground_height'] + 0.02 * (u[:, 2] - 0.5)],
                             -1)
        v = rand(n_bg, 3)
        lo, hi = spec['shell_radii']
        r = lo * (hi / lo) ** v[:, 0]
        a = 6.2831853 * v[:, 1]
        cz = v[:, 2] * 0.95
        sz = torch.sqrt(1.0 - cz * cz)
        shell = torch.stack([r * sz * torch.cos(a), r * sz * torch.sin(a),
                             r * cz], -1)
        return torch.cat([obj, ground, shell]).contiguous()
    if name == 'scales':
        base = torch.cat([
            torch.full((n_obj, 1), math.log(spec['object_scale']),
                       device=device),
            torch.full((n_ground, 1), math.log(spec['ground_scale']),
                       device=device)])
        pos = gaussian_leaf('positions', seed, spec, device)[n_obj + n_ground:]
        shell = torch.log(spec['shell_scale_per_unit'] *
                          torch.linalg.norm(pos, dim=-1, keepdim=True))
        base = torch.cat([base, shell])
        return (base + spec['log_scale_sigma'] * randn(n, 3)).contiguous()
    if name == 'rotations':
        q = randn(n, 4)
        return (q / torch.linalg.norm(q, dim=-1, keepdim=True)).contiguous()
    if name == 'opacities':
        lo, hi = spec['opacity_logit_clip']
        return torch.clamp(spec['opacity_logit_mean'] +
                           spec['opacity_logit_sigma'] * randn(n, 1), lo, hi)
    k = int(spec['sh_degree']) ** 2
    if name == 'features_dc':
        return (spec['sh_dc_sigma'] * randn(n, 1, 3)).contiguous()
    if name == 'features_rest':
        return (spec['sh_rest_sigma'] * randn(n, k - 1, 3)).contiguous()
    raise KeyError(name)


# -- MLP weights ----------------------------------------------------------------

def mlp_leaves(model_cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of every leaf of the NeRF model, as the published
    architecture lays it out: per block (coarse, then fine) a trunk of
    NUM_LAYERS linear layers, the input skip concatenated before
    SKIP_LAYER, a density and a feature head, a WIDTH/2 colour layer over
    feature + direction, and the RGB layer; each weight (out, in), then its
    bias."""
    width = int(model_cfg['WIDTH'])
    layers = int(model_cfg['NUM_LAYERS'])
    skip = int(model_cfg['SKIP_LAYER'])
    pos_dim = 3 * (2 * int(model_cfg['POSITION_FREQUENCIES']) + 1)
    dir_dim = 3 * (2 * int(model_cfg['DIRECTION_FREQUENCIES']) + 1)
    shapes = []
    in_dim = pos_dim
    for i in range(layers):
        if i == skip:
            in_dim += pos_dim
        shapes.append((f'trunk.{i}', width, in_dim))
        in_dim = width
    shapes += [('density', 1, width), ('feature', width, width),
               ('color_hidden', width // 2, width + dir_dim),
               ('color_out', 3, width // 2)]
    blocks = ('coarse', 'fine') if model_cfg.get('USE_COARSE', True) \
        else ('fine',)
    leaves = []
    for block in blocks:
        for name, out_dim, in_dim in shapes:
            leaves.append((f'{block}.{name}.weight', (out_dim, in_dim)))
            leaves.append((f'{block}.{name}.bias', (out_dim,)))
    return leaves


def mlp_weights(seed: int, model_cfg: dict, device) -> dict[str, torch.Tensor]:
    """Glorot-uniform weights U(-sqrt(6 / (in + out)), +) and zero biases,
    as the paper's released code initialises its dense layers, from one
    draw on the device. (The port's own initialisation, U(-1/sqrt(in),
    1/sqrt(in)) for weights and biases, shrinks the activations ~6x a
    layer, so the density head sees only its bias and is dead on about
    half of the seeds: no gradient to compare.)"""
    leaves = mlp_leaves(model_cfg)
    total = sum(math.prod(shape) for _, shape in leaves if len(shape) == 2)
    flat = torch.rand(total, generator=generator(seed, 'mlp', device),
                      device=device)
    out, offset = {}, 0
    for name, shape in leaves:
        if len(shape) == 1:
            out[name] = torch.zeros(shape, device=device)
            continue
        size = math.prod(shape)
        bound = math.sqrt(6.0 / (shape[0] + shape[1]))
        out[name] = (flat[offset:offset + size].view(shape) * (2 * bound)
                     - bound)
        offset += size
    return out
