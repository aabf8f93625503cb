"""3D Gaussian math: activations, covariances, EWA projection, and the 3DGS
frontend built from them.

Port of nerficg_tpu/ops/gaussian.py (reference: the projection half of
diff-gaussian-rasterization). ``gs_frontend`` turns the raw parameters into
the rasterizer's inputs: on CPU tensors by ``gs_frontend_plain``, the
batched PyTorch composition of the activations, ``build_covariance_3d``,
``project_gaussians`` and ``eval_sh`` (differentiable by autograd); on CUDA
tensors by the kernel pair of ``nerficg_torch/csrc/gs_frontend.cu``
(``gs_frontend_fwd``, ``gs_frontend_bwd``) in a ``torch.autograd.Function``
whose backward recomputes the forward from the parameters.
``gs_frontend_bwd_plain`` is the backward kernel's formulas in PyTorch, in
the inputs' dtype: the CPU tests hold it to autograd of the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from nerficg_torch.core.errors import KernelError
from nerficg_torch.ops import _kernels
from nerficg_torch.ops.encoding import (_SH_C1, _SH_C2, _SH_C3, eval_sh,
                                         sh_encode)

__all__ = ['quaternion_to_rotation', 'build_covariance_3d',
           'project_gaussians', 'activate_scales', 'activate_rotations',
           'activate_opacities', 'gs_frontend', 'gs_frontend_plain',
           'gs_frontend_fwd', 'gs_frontend_bwd', 'gs_frontend_bwd_plain',
           'FRONTEND_PARAMS', 'FRONTEND_OUTPUTS']

# The raw parameters the frontend reads, in the kernels' argument order:
# positions (N, 3), log scales (N, 3), wxyz quaternions (N, 4), opacity
# logits (N, 1), SH features_dc (N, 1, 3) and features_rest (N, K - 1, 3).
FRONTEND_PARAMS = ('positions', 'scales', 'rotations', 'opacities',
                   'features_dc', 'features_rest')
# Its outputs: means2d (N, 2) pixels, depths (N,), conics (N, 3), radii (N,)
# (0 where culled), colors (N, 3), opacities (N,), visible (N,) bool.
FRONTEND_OUTPUTS = ('means2d', 'depths', 'conics', 'radii', 'colors',
                    'opacities', 'visible')
# The outputs with a gradient.
_GRAD_OUTPUTS = ('means2d', 'depths', 'conics', 'colors', 'opacities')
# The frontend's near plane (``project_gaussians``' default).
NEAR = 0.01


def quaternion_to_rotation(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz (normalized by the caller) -> (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def build_covariance_3d(scales: torch.Tensor,
                        rotations: torch.Tensor) -> torch.Tensor:
    """(N, 3) scales + (N, 4) unit quaternions -> (N, 3, 3) covariances
    R S S^T R^T."""
    m = quaternion_to_rotation(rotations) * scales[:, None, :]
    return m @ m.transpose(-1, -2)


def project_gaussians(means3d: torch.Tensor, cov3d: torch.Tensor,
                      w2c: torch.Tensor, focal_x: float, focal_y: float,
                      center_x: float, center_y: float, width: int,
                      height: int, near: float = 0.01,
                      low_pass: float = 0.3) -> dict:
    """EWA splatting projection (nerficg_tpu/ops/gaussian.py:41-106):
    means2d (N, 2) pixels, depths (N,), conics (N, 3) inverse 2D covariance
    (a, b, c), radii (N,) 3-sigma pixel radius (0 where culled), in_frustum
    (N,) bool."""
    cam = means3d @ w2c[:3, :3].T + w2c[:3, 3]
    x, y, z = cam[..., 0], cam[..., 1], cam[..., 2]
    in_front = z > near
    z_safe = torch.clamp(z, min=near)
    px = x / z_safe * focal_x + center_x
    py = y / z_safe * focal_y + center_y
    # Jacobian of the projection with the tan-fov clamp of the reference
    # kernel at the frustum edge.
    lim_x = 1.3 * (0.5 * width / focal_x)
    lim_y = 1.3 * (0.5 * height / focal_y)
    tx = torch.clamp(x / z_safe, -lim_x, lim_x) * z_safe
    ty = torch.clamp(y / z_safe, -lim_y, lim_y) * z_safe
    zero = torch.zeros_like(z_safe)
    j_row0 = torch.stack([focal_x / z_safe, zero,
                          -focal_x * tx / (z_safe ** 2)], -1)
    j_row1 = torch.stack([zero, focal_y / z_safe,
                          -focal_y * ty / (z_safe ** 2)], -1)
    jac = torch.stack([j_row0, j_row1], dim=-2)                # (N, 2, 3)
    t = jac @ w2c[:3, :3]
    cov2d = t @ cov3d @ t.transpose(-1, -2)
    a = cov2d[..., 0, 0] + low_pass
    b = cov2d[..., 0, 1]
    c = cov2d[..., 1, 1] + low_pass
    det = a * c - b * b
    det_safe = torch.clamp(det, min=1e-12)
    conics = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)
    mid = 0.5 * (a + c)
    eig1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radii = torch.ceil(3.0 * torch.sqrt(torch.clamp(eig1, min=0.0)))
    visible = in_front & (det > 0) & (px + radii > 0) & \
        (px - radii < width) & (py + radii > 0) & (py - radii < height)
    return {'means2d': torch.stack([px, py], dim=-1), 'depths': z,
            'conics': conics, 'radii': torch.where(visible, radii, 0.0),
            'in_frustum': visible}


# -- activations of the raw parameters -----------------------------------------

def activate_scales(raw: torch.Tensor) -> torch.Tensor:
    # Clamped so that a runaway raw scale cannot give inf covariances.
    return torch.exp(torch.clamp(raw, -15.0, 10.0))


def activate_rotations(raw: torch.Tensor) -> torch.Tensor:
    # rsqrt(max(.)) keeps the gradient finite at the zero quaternions of
    # padding rows, where a norm would give NaN.
    return raw * torch.rsqrt(torch.clamp((raw * raw).sum(-1, keepdim=True),
                                         min=1e-12))


def activate_opacities(raw: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(raw)[:, 0]


# -- the frontend --------------------------------------------------------------

def gs_frontend(params: dict, w2c: torch.Tensor, cam_pos: torch.Tensor,
                intrinsics: tuple, sh_degree: int,
                low_pass: float = 0.3) -> dict:
    """Every Gaussian's rasterizer inputs (``FRONTEND_OUTPUTS``) from the raw
    parameters (``FRONTEND_PARAMS`` of ``params``), the camera (w2c (4, 4),
    position (3,), intrinsics (focal_x, focal_y, center_x, center_y, W, H))
    and the active SH bands ``sh_degree`` (1-4); differentiable in the
    parameters. CPU tensors take the plain version and autograd; CUDA
    tensors launch the kernels."""
    if params['positions'].device.type == 'cpu':
        return gs_frontend_plain(params, w2c, cam_pos, intrinsics, sh_degree,
                                 low_pass)
    out = _GsFrontend.apply(*(params[k] for k in FRONTEND_PARAMS), w2c,
                            cam_pos, intrinsics, int(sh_degree),
                            float(low_pass))
    return dict(zip(FRONTEND_OUTPUTS, out))


def gs_frontend_plain(params: dict, w2c: torch.Tensor, cam_pos: torch.Tensor,
                      intrinsics: tuple, sh_degree: int,
                      low_pass: float = 0.3) -> dict:
    """The plain version of ``gs_frontend`` (nerficg_tpu renderer :65-85):
    covariances, the EWA projection and the view-dependent SH color
    (reference: utils.py:21-59) as batched PyTorch."""
    focal_x, focal_y, center_x, center_y, width, height = intrinsics
    positions = params['positions']
    cov3d = build_covariance_3d(activate_scales(params['scales']),
                                activate_rotations(params['rotations']))
    proj = project_gaussians(positions, cov3d, w2c, focal_x, focal_y,
                             center_x, center_y, width, height, near=NEAR,
                             low_pass=low_pass)
    directions = positions - cam_pos
    directions = directions / torch.clamp(
        torch.linalg.norm(directions, dim=-1, keepdim=True), min=1e-8)
    features = torch.cat([params['features_dc'], params['features_rest']],
                         dim=1)                                 # (N, K, 3)
    colors = eval_sh(features, directions, sh_degree)
    return {'means2d': proj['means2d'], 'depths': proj['depths'],
            'conics': proj['conics'], 'radii': proj['radii'],
            'colors': torch.clamp(colors + 0.5, min=0.0),
            'opacities': activate_opacities(params['opacities']),
            'visible': proj['in_frustum']}


def _check(name: str, params: dict, w2c: torch.Tensor,
           cam_pos: torch.Tensor, sh_degree: int) -> tuple[int, int]:
    """The kernels' refusals; returns (N, stored SH coefficients K)."""
    raw = [params[k] for k in FRONTEND_PARAMS]
    _kernels.require_cuda(name, *raw, w2c, cam_pos,
                          dtypes=(torch.float32,) * 8)
    n = raw[0].shape[0]
    k = raw[5].shape[1] + 1 if raw[5].ndim == 3 else 0
    shapes = {'positions': (n, 3), 'scales': (n, 3), 'rotations': (n, 4),
              'opacities': (n, 1), 'features_dc': (n, 1, 3),
              'features_rest': (n, k - 1, 3)}
    for key, shape in shapes.items():
        if tuple(params[key].shape) != shape:
            raise KernelError(f'{name}: {key} must be {shape}, got '
                              f'{tuple(params[key].shape)}')
    if tuple(w2c.shape) != (4, 4) or tuple(cam_pos.shape) != (3,):
        raise KernelError(f'{name}: w2c must be (4, 4) and cam_pos (3,)')
    if k not in (1, 4, 9, 16) or not 1 <= sh_degree * sh_degree <= k:
        raise KernelError(f'{name}: {k} stored SH coefficients and '
                          f'{sh_degree} active bands (1-4 bands, at most '
                          f'the stored ones)')
    if params['rotations'].data_ptr() % 16:
        raise KernelError(f'{name}: rotations must be 16-byte aligned')
    return n, k


def _camera_floats(intrinsics: tuple, low_pass: float):
    """The kernels' ``Camera``: focal lengths, principal point, the tan-fov
    clamp (computed in double, as the plain version's Python floats),
    W, H, near, low pass."""
    fx, fy, cx, cy, width, height = intrinsics
    values = (fx, fy, cx, cy, 1.3 * (0.5 * width / fx),
              1.3 * (0.5 * height / fy), width, height, NEAR, low_pass)
    return (ctypes.c_float * 10)(*map(float, values))


def gs_frontend_fwd(params: dict, w2c: torch.Tensor, cam_pos: torch.Tensor,
                    intrinsics: tuple, sh_degree: int,
                    low_pass: float = 0.3) -> dict:
    """The forward kernel: ``gs_frontend``'s outputs, not differentiable.
    CUDA tensors launch the kernel, CPU tensors take the plain version."""
    if params['positions'].device.type == 'cpu':
        with torch.no_grad():
            return gs_frontend_plain(params, w2c, cam_pos, intrinsics,
                                     sh_degree, low_pass)
    name = 'gs_frontend_fwd'
    n, k = _check(name, params, w2c, cam_pos, sh_degree)
    dev = w2c.device
    out = {key: torch.empty(shape, dtype=torch.float32, device=dev)
           for key, shape in (('means2d', (n, 2)), ('depths', (n,)),
                              ('conics', (n, 3)), ('radii', (n,)),
                              ('colors', (n, 3)), ('opacities', (n,)))}
    out['visible'] = torch.empty((n,), dtype=torch.bool, device=dev)
    code = _kernels.load_library().nerficg_gs_frontend_fwd(
        *(params[key].data_ptr() for key in FRONTEND_PARAMS),
        w2c.data_ptr(), cam_pos.data_ptr(),
        _camera_floats(intrinsics, low_pass),
        *(out[key].data_ptr() for key in FRONTEND_OUTPUTS), n, k,
        sh_degree * sh_degree, _kernels.stream_of(w2c))
    _kernels.check(code, name)
    gs_frontend_fwd.launches += 1
    return {key: out[key] for key in FRONTEND_OUTPUTS}


def gs_frontend_bwd(params: dict, w2c: torch.Tensor, cam_pos: torch.Tensor,
                    intrinsics: tuple, sh_degree: int, grads: dict,
                    low_pass: float = 0.3) -> dict:
    """The backward kernel: the gradients of the six ``FRONTEND_PARAMS``,
    in their shapes, from those of the outputs (``grads``: means2d,
    depths, conics, colors, opacities; a missing or None one is zero).
    CUDA tensors launch the kernel, CPU tensors take
    ``gs_frontend_bwd_plain``."""
    if params['positions'].device.type == 'cpu':
        return gs_frontend_bwd_plain(params, w2c, cam_pos, intrinsics,
                                     sh_degree, grads, low_pass)
    name = 'gs_frontend_bwd'
    n, k = _check(name, params, w2c, cam_pos, sh_degree)
    g = {key: grads.get(key) for key in _GRAD_OUTPUTS}
    given = [t for t in g.values() if t is not None]
    if given:
        _kernels.require_cuda(name, w2c, *given,
                              dtypes=(torch.float32,) * (1 + len(given)))
    for key, shape in (('means2d', (n, 2)), ('depths', (n,)),
                       ('conics', (n, 3)), ('colors', (n, 3)),
                       ('opacities', (n,))):
        if g[key] is not None and tuple(g[key].shape) != shape:
            raise KernelError(f'{name}: d {key} must be {shape}, got '
                              f'{tuple(g[key].shape)}')
    d = {key: torch.empty_like(params[key]) for key in FRONTEND_PARAMS}
    code = _kernels.load_library().nerficg_gs_frontend_bwd(
        *(params[key].data_ptr() for key in FRONTEND_PARAMS),
        w2c.data_ptr(), cam_pos.data_ptr(),
        _camera_floats(intrinsics, low_pass),
        *(_kernels.ptr(g[key]) for key in _GRAD_OUTPUTS),
        *(d[key].data_ptr() for key in FRONTEND_PARAMS), n, k,
        sh_degree * sh_degree, _kernels.stream_of(w2c))
    _kernels.check(code, name)
    gs_frontend_bwd.launches += 1
    return d


gs_frontend_fwd.launches = 0
gs_frontend_bwd.launches = 0


class _GsFrontend(torch.autograd.Function):
    """``gs_frontend`` on CUDA tensors: the forward kernel, and the backward
    kernel from the saved inputs alone (no intermediate is kept)."""

    @staticmethod
    def forward(ctx, positions, scales, rotations, opacities, features_dc,
                features_rest, w2c, cam_pos, intrinsics, sh_degree,
                low_pass):
        params = dict(zip(FRONTEND_PARAMS, (positions, scales, rotations,
                                            opacities, features_dc,
                                            features_rest)))
        out = gs_frontend_fwd(params, w2c, cam_pos, intrinsics, sh_degree,
                              low_pass)
        ctx.save_for_backward(*params.values(), w2c, cam_pos)
        ctx.view = (intrinsics, sh_degree)
        ctx.low_pass = low_pass
        ctx.mark_non_differentiable(out['radii'], out['visible'])
        ctx.set_materialize_grads(False)
        return tuple(out.values())

    @staticmethod
    def backward(ctx, *grads):
        *raw, w2c, cam_pos = ctx.saved_tensors
        given = dict(zip(FRONTEND_OUTPUTS, grads))
        d = gs_frontend_bwd(
            dict(zip(FRONTEND_PARAMS, raw)), w2c, cam_pos, *ctx.view,
            {key: None if given[key] is None else given[key].contiguous()
             for key in _GRAD_OUTPUTS}, ctx.low_pass)
        return (*d.values(), None, None, None, None, None)


# -- the backward's formulas, for the CPU ----------------------------------------

def _sh_basis_grad(d: torch.Tensor, gb: torch.Tensor) -> torch.Tensor:
    """d(sum_k basis_k(d) gb_k) / dd over the gb.shape[-1] coefficients:
    ``sh_basis_grad`` of csrc/gs_frontend.cu."""
    x, y, z = d.unbind(-1)
    coeffs = gb.shape[-1]
    gd = torch.zeros_like(d)
    gx, gy, gz = gd.unbind(-1)
    if coeffs > 1:
        gx = gx - _SH_C1 * gb[:, 3]
        gy = gy - _SH_C1 * gb[:, 1]
        gz = gz + _SH_C1 * gb[:, 2]
    if coeffs > 4:
        c = _SH_C2
        gx = gx + c[0] * y * gb[:, 4] + c[2] * (-2.0 * x) * gb[:, 6] + \
            c[3] * z * gb[:, 7] + c[4] * (2.0 * x) * gb[:, 8]
        gy = gy + c[0] * x * gb[:, 4] + c[1] * z * gb[:, 5] + \
            c[2] * (-2.0 * y) * gb[:, 6] + c[4] * (-2.0 * y) * gb[:, 8]
        gz = gz + c[1] * y * gb[:, 5] + c[2] * (4.0 * z) * gb[:, 6] + \
            c[3] * x * gb[:, 7]
    if coeffs > 9:
        c = _SH_C3
        xx, yy, zz = x * x, y * y, z * z
        gx = gx + c[0] * (6.0 * x * y) * gb[:, 9] + \
            c[1] * (y * z) * gb[:, 10] + c[2] * (-2.0 * x * y) * gb[:, 11] + \
            c[3] * (-6.0 * x * z) * gb[:, 12] + \
            c[4] * (4.0 * zz - 3.0 * xx - yy) * gb[:, 13] + \
            c[5] * (2.0 * x * z) * gb[:, 14] + \
            c[6] * (3.0 * xx - 3.0 * yy) * gb[:, 15]
        gy = gy + c[0] * (3.0 * xx - 3.0 * yy) * gb[:, 9] + \
            c[1] * (x * z) * gb[:, 10] + \
            c[2] * (4.0 * zz - xx - 3.0 * yy) * gb[:, 11] + \
            c[3] * (-6.0 * y * z) * gb[:, 12] + \
            c[4] * (-2.0 * x * y) * gb[:, 13] + \
            c[5] * (-2.0 * y * z) * gb[:, 14] + \
            c[6] * (-6.0 * x * y) * gb[:, 15]
        gz = gz + c[1] * (x * y) * gb[:, 10] + \
            c[2] * (8.0 * y * z) * gb[:, 11] + \
            c[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy) * gb[:, 12] + \
            c[4] * (8.0 * x * z) * gb[:, 13] + c[5] * (xx - yy) * gb[:, 14]
    return torch.stack([gx, gy, gz], -1)


def gs_frontend_bwd_plain(params: dict, w2c: torch.Tensor,
                          cam_pos: torch.Tensor, intrinsics: tuple,
                          sh_degree: int, grads: dict,
                          low_pass: float = 0.3) -> dict:
    """``gs_frontend_bwd`` by the backward kernel's formulas (csrc/
    gs_frontend.cu ``frontend_bwd_kernel``), batched, in the inputs' dtype:
    the forward recomputed, then each step's gradient by hand with
    autograd's conventions at the clamps."""
    fx, fy, cx, cy, width, height = intrinsics
    lim_x, lim_y = 1.3 * (0.5 * width / fx), 1.3 * (0.5 * height / fy)
    p = params['positions']
    n = p.shape[0]

    def grad(key, shape):
        g = grads.get(key)
        return p.new_zeros(shape) if g is None else g

    # The forward.
    s_raw, q_raw = params['scales'], params['rotations']
    s = activate_scales(s_raw)
    ss = (q_raw * q_raw).sum(-1, keepdim=True)
    r = torch.rsqrt(torch.clamp(ss, min=1e-12))
    q = q_raw * r
    rot = quaternion_to_rotation(q)
    m = rot * s[:, None, :]
    cov3d = m @ m.transpose(-1, -2)
    w = w2c[:3, :3]
    cam = p @ w.T + w2c[:3, 3]
    x, y, z = cam.unbind(-1)
    zs = torch.clamp(z, min=NEAR)
    u, v = x / zs, y / zs
    ucl, vcl = torch.clamp(u, -lim_x, lim_x), torch.clamp(v, -lim_y, lim_y)
    tx, ty = ucl * zs, vcl * zs
    jac = p.new_zeros((n, 2, 3))
    jac[:, 0, 0], jac[:, 0, 2] = fx / zs, -fx * tx / zs ** 2
    jac[:, 1, 1], jac[:, 1, 2] = fy / zs, -fy * ty / zs ** 2
    t = jac @ w
    a_mat = t @ cov3d
    c2 = a_mat @ t.transpose(-1, -2)
    a, b, c = c2[:, 0, 0] + low_pass, c2[:, 0, 1], c2[:, 1, 1] + low_pass
    det = a * c - b * b
    ds = torch.clamp(det, min=1e-12)
    direction = p - cam_pos
    norm = torch.linalg.norm(direction, dim=-1)
    nc = torch.clamp(norm, min=1e-8)
    d = direction / nc[:, None]
    coeffs = sh_degree * sh_degree
    basis = sh_encode(d, sh_degree)[:, :coeffs]
    feats = torch.cat([params['features_dc'], params['features_rest']],
                      dim=1)
    col = torch.einsum('nkc,nk->nc', feats[:, :coeffs], basis)
    op = activate_opacities(params['opacities'])

    # Opacity and colour.
    gop = grad('opacities', (n,))
    d_opacities = (gop * (1.0 - op) * op)[:, None]
    gcol = torch.where(col + 0.5 >= 0.0, grad('colors', (n, 3)), 0.0)
    d_feats = torch.zeros_like(feats)
    d_feats[:, :coeffs] = basis[:, :, None] * gcol[:, None, :]
    gbasis = torch.einsum('nkc,nc->nk', feats[:, :coeffs], gcol)
    gbasis[:, 0] = 0.0
    gd = _sh_basis_grad(d, gbasis)
    gdot = (gd * direction).sum(-1)
    gn = torch.where(norm >= 1e-8, -gdot / (nc * nc) / norm, 0.0)
    d_positions = gd / nc[:, None] + gn[:, None] * direction

    # The conic, the 2D covariance and the projection.
    gcon = grad('conics', (n, 3))
    gca, gcb, gcc = gcon.unbind(-1)
    ids = 1.0 / ds
    ga, gb, gc = gcc * ids, -gcb * ids, gca * ids
    gds = (-gca * c + gcb * b - gcc * a) * ids * ids
    gdet = torch.where(det >= 1e-12, gds, 0.0)
    ga, gc, gb = ga + gdet * c, gc + gdet * a, gb - 2.0 * b * gdet
    g_sym = torch.stack([torch.stack([2.0 * ga, gb], -1),
                         torch.stack([gb, 2.0 * gc], -1)], -2)
    d_t = g_sym @ a_mat
    p_mat = t.transpose(-1, -2) @ g_sym @ t
    p_mat = 0.5 * (p_mat + p_mat.transpose(-1, -2))
    d_jac = d_t @ w.T
    dj00, dj02 = d_jac[:, 0, 0], d_jac[:, 0, 2]
    dj11, dj12 = d_jac[:, 1, 1], d_jac[:, 1, 2]
    izs = 1.0 / zs
    izs2 = izs * izs
    gzs = -(dj00 * fx + dj11 * fy) * izs2 + \
        2.0 * (dj02 * fx * tx + dj12 * fy * ty) * izs2 * izs
    gtx, gty = -dj02 * fx * izs2, -dj12 * fy * izs2
    gm = grad('means2d', (n, 2))
    gu = gm[:, 0] * fx + torch.where((u >= -lim_x) & (u <= lim_x),
                                     gtx * zs, 0.0)
    gv = gm[:, 1] * fy + torch.where((v >= -lim_y) & (v <= lim_y),
                                     gty * zs, 0.0)
    gzs = gzs + gtx * ucl + gty * vcl - (gu * x + gv * y) * izs2
    gcam = torch.stack([gu * izs, gv * izs,
                        grad('depths', (n,)) +
                        torch.where(z >= NEAR, gzs, 0.0)], -1)
    d_positions = d_positions + gcam @ w

    # The covariance, the scales and the rotation.
    d_m = p_mat @ m
    d_rot = d_m * s[:, None, :]
    gs = (d_m * rot).sum(1)
    d_scales = torch.where((s_raw >= -15.0) & (s_raw <= 10.0), gs * s, 0.0)
    qw, qx, qy, qz = q.unbind(-1)
    dr = [[d_rot[:, i, j] for j in range(3)] for i in range(3)]
    dq = torch.stack([
        2.0 * (-qz * dr[0][1] + qy * dr[0][2] + qz * dr[1][0] -
               qx * dr[1][2] - qy * dr[2][0] + qx * dr[2][1]),
        2.0 * (qy * dr[0][1] + qz * dr[0][2] + qy * dr[1][0] -
               2.0 * qx * dr[1][1] - qw * dr[1][2] + qz * dr[2][0] +
               qw * dr[2][1] - 2.0 * qx * dr[2][2]),
        2.0 * (-2.0 * qy * dr[0][0] + qx * dr[0][1] + qw * dr[0][2] +
               qx * dr[1][0] + qz * dr[1][2] - qw * dr[2][0] +
               qz * dr[2][1] - 2.0 * qy * dr[2][2]),
        2.0 * (-2.0 * qz * dr[0][0] - qw * dr[0][1] + qx * dr[0][2] +
               qw * dr[1][0] - 2.0 * qz * dr[1][1] + qy * dr[1][2] +
               qx * dr[2][0] + qy * dr[2][1])], -1)
    qdot = (dq * q_raw).sum(-1, keepdim=True)
    gr = torch.where(ss >= 1e-12, r * r * r * qdot, 0.0)
    d_rotations = r * dq - gr * q_raw
    return {'positions': d_positions, 'scales': d_scales,
            'rotations': d_rotations, 'opacities': d_opacities,
            'features_dc': d_feats[:, :1].contiguous(),
            'features_rest': d_feats[:, 1:].contiguous()}

