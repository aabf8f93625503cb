"""The port's 3DGS stream compositor (#15/#16) against the JAX package.

The plain versions (what the CUDA kernels are held to on the card) against
the JAX oracle ``_cs_jnp`` and against the Pallas kernels run in interpret
mode, as tests/test_gs_tiles_kernel.py runs them: forwards within atol 1e-5,
gradients within JAX's own 2e-3 / 1e-3. The streams hold tiles with count 0
and with count > k.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.core.errors import KernelError
from nerficg_torch.ops import gs_tiles_kernel as tk
from nerficg_tpu.ops import gs_tiles_kernel as gtk
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

K = 128
TILES_X = 3
# Tile 0 overflows (200 > k) from a 128-aligned start: the TPU kernel keeps
# to k only there (ROADMAP Queue C); tile 2 is empty.
COUNTS = np.array([200, 37, 0, K, 5, 60], np.int32)


def _interp():
    orig = gtk.pl.pallas_call

    def call(*a, **kw):
        kw['interpret'] = True
        kw.pop('compiler_params', None)
        return orig(*a, **kw)
    return mock.patch.object(gtk.pl, 'pallas_call', call)


def _attrs(rng, e_pad):
    """(e_pad, 10) attributes; means spread over the 3x2 tiles and around."""
    return np.concatenate([
        rng.uniform(-4.0, 52.0, (e_pad, 1)), rng.uniform(-4.0, 36.0, (e_pad, 1)),
        rng.uniform(0.05, 0.3, (e_pad, 1)), rng.uniform(-0.02, 0.02, (e_pad, 1)),
        rng.uniform(0.05, 0.3, (e_pad, 1)), rng.uniform(0.05, 0.9, (e_pad, 1)),
        rng.uniform(0.0, 1.0, (e_pad, 3)), rng.uniform(1.0, 5.0, (e_pad, 1)),
    ], axis=1).astype(np.float32)


def _segments():
    starts = np.concatenate([[0], np.cumsum(COUNTS)[:-1]]).astype(np.int32)
    e = int(COUNTS.sum())
    return starts, -(-(e + 3 * K) // K) * K


@pytest.fixture(scope='module')
def stream16():
    starts, e_pad = _segments()
    mat = np.zeros((16, e_pad), np.float32)
    mat[:10] = _attrs(np.random.default_rng(0), e_pad).T
    return mat, starts


def _pack(attrs, starts):
    """(e_pad, 10) -> (8, e_pad) packed words with each entry's mean
    relative to its tile's origin (the serving layout)."""
    e_pad = attrs.shape[0]
    tile = np.searchsorted(np.cumsum(COUNTS), np.arange(e_pad),
                           side='right').clip(0, len(COUNTS) - 1)
    ox = (tile % TILES_X) * 16.0
    oy = (tile // TILES_X) * 16.0
    q = np.clip(np.round((attrs[:, :2] - np.stack([ox, oy], -1)) * 32.0 +
                         1024.0 * 32.0), 0, 65535).astype(np.uint32)

    def bf16(a):
        return np.asarray(jax.lax.bitcast_convert_type(
            jnp.asarray(a).astype(jnp.bfloat16), jnp.uint16)).astype(
            np.uint32)

    words = [(q[:, 0] << 16) | q[:, 1]] + [
        (bf16(attrs[:, 2 * i]) << 16) | bf16(attrs[:, 2 * i + 1])
        for i in range(1, 5)]
    mat = np.zeros((8, e_pad), np.uint32)
    mat[:5] = np.stack(words)
    return mat.view(np.float32)


@pytest.fixture(scope='module')
def stream8():
    starts, e_pad = _segments()
    return _pack(_attrs(np.random.default_rng(1), e_pad), starts), starts


def _jax_fwd(mat, starts):
    return np.asarray(gtk._cs_jnp(jnp.asarray(mat), jnp.asarray(starts),
                                  jnp.asarray(COUNTS), TILES_X, len(COUNTS),
                                  K))


def _port_fwd(mat, starts):
    return tk.gs_composite_fwd_plain(
        torch.tensor(mat), torch.tensor(starts), torch.tensor(COUNTS),
        TILES_X, len(COUNTS), K, save_tacc=mat.shape[0] == 16)


@pytest.mark.parametrize('layout', ['stream16', 'stream8'])
def test_forward_matches_oracle(layout, request):
    """atol 1e-5 against _cs_jnp, every tile (count 0 and count > k); the
    oracle's rows past the port's 5 are zero padding."""
    mat, starts = request.getfixturevalue(layout)
    got = _port_fwd(mat, starts)
    got = got[0] if isinstance(got, tuple) else got
    want = _jax_fwd(mat, starts)
    assert got.shape == (len(COUNTS), tk.OUT_ROWS, tk.P)
    assert not want[:, tk.OUT_ROWS:].any()
    np.testing.assert_allclose(got.numpy(), want[:, :tk.OUT_ROWS], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize('layout', ['stream16', 'stream8'])
def test_forward_matches_interpret_kernel(layout, request):
    """atol 1e-5 against the Pallas kernel #15 in interpret mode; the packed
    kernel composites tile-local, the port absolute: the same bits."""
    mat, starts = request.getfixturevalue(layout)
    with _interp():
        want = np.asarray(gtk._run_fused_fwd(
            jnp.asarray(mat), jnp.asarray(starts), jnp.asarray(COUNTS),
            TILES_X, len(COUNTS), K))
    got = _port_fwd(mat, starts)
    got = got[0] if isinstance(got, tuple) else got
    np.testing.assert_allclose(got.numpy(), want[:, :tk.OUT_ROWS], rtol=0,
                               atol=1e-5)


def test_saved_transmittance(stream16):
    """tacc[t, c] is the transmittance before entry c * CH: one minus the
    oracle's accumulated alpha over the first min(count, c * CH, k)
    entries; chunks past the segment hold the final transmittance."""
    mat, starts = stream16
    _, tacc = _port_fwd(mat, starts)
    assert tacc.shape == (len(COUNTS), tk.num_chunks(K), tk.P)
    # The chunks the kernel writes: ceil(min(count, k) / CH) per tile.
    np.testing.assert_array_equal(
        tk.live_chunks(torch.tensor(COUNTS), K).sum(1).numpy(),
        -(-np.minimum(COUNTS, K) // tk.CH))
    for c in range(tk.num_chunks(K)):
        clipped = np.minimum(np.minimum(COUNTS, K), c * tk.CH)
        acc = np.asarray(gtk._cs_jnp(jnp.asarray(mat), jnp.asarray(starts),
                                     jnp.asarray(clipped), TILES_X,
                                     len(COUNTS), K))[:, 3]
        np.testing.assert_allclose(tacc[:, c].numpy(), 1.0 - acc, rtol=0,
                                   atol=1e-5)


@pytest.fixture(scope='module')
def dout():
    """d out in the JAX layout, (T, 8, P); the port takes its 5 rows."""
    return np.random.default_rng(9).normal(
        size=(len(COUNTS), 8, tk.P)).astype(np.float32)


def _port_grad(mat, starts, dout):
    m = torch.tensor(mat, requires_grad=True)
    out = tk.composite_sorted(m, torch.tensor(starts), torch.tensor(COUNTS),
                              TILES_X, len(COUNTS), K)
    (out * torch.tensor(dout[:, :tk.OUT_ROWS])).sum().backward()
    return m.grad.numpy()


def test_gradient_matches_jax_grad(stream16, dout):
    """Within JAX's own 2e-3 / 1e-3 of jax.grad of _cs_jnp."""
    mat, starts = stream16
    want = np.asarray(jax.grad(lambda sm: jnp.sum(gtk._cs_jnp(
        sm, jnp.asarray(starts), jnp.asarray(COUNTS), TILES_X, len(COUNTS),
        K) * dout))(jnp.asarray(mat)))
    np.testing.assert_allclose(_port_grad(mat, starts, dout), want,
                               atol=2e-3, rtol=1e-3)


def test_gradient_matches_interpret_stream_backward(stream16, dout):
    """Against the Pallas stream backward #16 fed the forward's saved
    transmittance, in interpret mode, within 2e-3 / 1e-3."""
    mat, starts = stream16
    args = (jnp.asarray(mat), jnp.asarray(starts), jnp.asarray(COUNTS))
    with _interp():
        _, tacc = gtk._run_fused_fwd(*args, TILES_X, len(COUNTS), K,
                                     save_tacc=True)
        want = np.asarray(gtk._run_fused_bwd_stream(
            *args, jnp.asarray(dout), TILES_X, len(COUNTS), K, tacc=tacc))
    np.testing.assert_allclose(_port_grad(mat, starts, dout), want,
                               atol=2e-3, rtol=1e-3)


def test_gradient_zero_outside_segments(stream16, dout):
    """Rows past k, guard rows and channels 10-15 get no gradient."""
    mat, starts = stream16
    grad = _port_grad(mat, starts, dout)
    assert np.isfinite(grad).all()
    assert not grad[10:].any()
    assert not grad[:, starts[0] + K:starts[1]].any()     # tile 0 past k
    assert not grad[:, int(COUNTS.sum()):].any()           # guard rows
    assert grad[:, :starts[0] + K].any()


def test_packed_is_not_differentiable(stream8, dout):
    mat, starts = stream8
    m = torch.tensor(mat, requires_grad=True)
    out = tk.composite_sorted(m, torch.tensor(starts), torch.tensor(COUNTS),
                              TILES_X, len(COUNTS), K)
    with pytest.raises(KernelError):
        (out * torch.tensor(dout[:, :tk.OUT_ROWS])).sum().backward()


def test_cpu_wrappers_take_the_plain_versions(stream16, stream8, dout):
    """On CPU tensors every wrapper returns its plain version's result and
    counts no launch."""
    before = (tk.gs_composite_fwd.launches,
              tk.gs_composite_fwd_packed.launches,
              tk.gs_composite_bwd.launches)
    mat, starts = stream16
    args = (torch.tensor(starts), torch.tensor(COUNTS), TILES_X,
            len(COUNTS), K)
    out, tacc = tk.gs_composite_fwd(torch.tensor(mat), *args)
    want_out, want_tacc = tk.gs_composite_fwd_plain(torch.tensor(mat), *args)
    assert torch.equal(out, want_out) and torch.equal(tacc, want_tacc)
    d_out = torch.tensor(dout[:, :tk.OUT_ROWS])
    d = tk.gs_composite_bwd(torch.tensor(mat), *args[:2], tacc, d_out,
                            *args[2:])
    assert torch.equal(d, tk.gs_composite_bwd_plain(
        torch.tensor(mat), *args[:2], d_out, *args[2:]))
    mat8, starts8 = stream8
    assert torch.equal(
        tk.gs_composite_fwd_packed(torch.tensor(mat8), *args),
        tk.gs_composite_fwd_plain(torch.tensor(mat8), *args,
                                  save_tacc=False))
    assert (tk.gs_composite_fwd.launches, tk.gs_composite_fwd_packed.launches,
            tk.gs_composite_bwd.launches) == before
