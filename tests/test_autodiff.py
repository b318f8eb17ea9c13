"""Differentiability of the public transforms on both engines, verified
against jax.numpy.fft's gradients."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from smfft import api

from conftest import max_abs_err

N = 256
B = 4


def _cdata(rng, shape):
    return jnp.array((rng.random(shape) + 1j * rng.random(shape)
                      - 0.5 - 0.5j).astype(np.complex64))


def _rdata(rng, shape):
    return jnp.array((rng.random(shape) - 0.5).astype(np.float32))


@pytest.fixture(params=["jnp", "xla"])
def backend(request):
    return request.param


def test_fft_vjp_matches_jnp(rng, backend):
    x = _cdata(rng, (B, N))
    g = _cdata(rng, (B, N))
    _, vjp = jax.vjp(lambda v: api.fft(v, backend=backend), x)
    _, vjp_ref = jax.vjp(jnp.fft.fft, x)
    assert max_abs_err(np.asarray(vjp(g)[0]),
                       np.asarray(vjp_ref(g)[0])) < 1e-3


@pytest.mark.parametrize("norm", ["backward", None])
def test_ifft_vjp_matches_jnp(rng, norm, backend):
    x = _cdata(rng, (B, N))
    g = _cdata(rng, (B, N))
    _, vjp = jax.vjp(lambda v: api.ifft(v, backend=backend, norm=norm), x)
    scale = 1.0 if norm == "backward" else N
    _, vjp_ref = jax.vjp(lambda v: jnp.fft.ifft(v) * scale, x)
    assert max_abs_err(np.asarray(vjp(g)[0]),
                       np.asarray(vjp_ref(g)[0])) < 1e-3


def test_rfft_vjp_matches_jnp(rng, backend):
    x = _rdata(rng, (B, N))
    g = _cdata(rng, (B, N // 2 + 1))
    _, vjp = jax.vjp(lambda v: api.rfft(v, backend=backend), x)
    _, vjp_ref = jax.vjp(jnp.fft.rfft, x)
    got, ref = np.asarray(vjp(g)[0]), np.asarray(vjp_ref(g)[0])
    assert got.dtype == np.float32
    assert max_abs_err(got, ref) < 1e-3


@pytest.mark.parametrize("norm", ["backward", None])
def test_irfft_vjp_matches_jnp(rng, norm, backend):
    spec = _cdata(rng, (B, N // 2 + 1))
    g = _rdata(rng, (B, N))
    _, vjp = jax.vjp(lambda v: api.irfft(v, n=N, backend=backend,
                                         norm=norm), spec)
    scale = 1.0 if norm == "backward" else N // 2
    _, vjp_ref = jax.vjp(lambda v: jnp.fft.irfft(v, N) * scale, spec)
    assert max_abs_err(np.asarray(vjp(g)[0]),
                       np.asarray(vjp_ref(g)[0])) < 1e-3


def test_grad_through_fft_loss(rng, backend):
    """grad of a real scalar loss through the transform equals the same
    grad through jnp.fft, and jit composes."""
    x = _cdata(rng, (B, N))

    def loss(fn):
        return lambda v: jnp.sum(jnp.abs(fn(v)) ** 2)

    g1 = jax.jit(jax.grad(loss(lambda v: api.fft(v, backend=backend))))(x)
    g2 = jax.grad(loss(jnp.fft.fft))(x)
    assert max_abs_err(np.asarray(g1), np.asarray(g2)) < 2e-2


def test_convolve_vjp_both_args(rng, backend):
    x = _cdata(rng, (B, N))
    h = _cdata(rng, (N,))

    def ref_conv(x_, h_):
        return jnp.fft.ifft(jnp.fft.fft(x_) * h_)

    g = _cdata(rng, (B, N))
    _, vjp = jax.vjp(lambda a, b: api.convolve(a, b, backend=backend),
                     x, h)
    _, vjp_ref = jax.vjp(ref_conv, x, h)
    gx, gh = vjp(g)
    rx, rh = vjp_ref(g)
    assert max_abs_err(np.asarray(gx), np.asarray(rx)) < 1e-3
    assert max_abs_err(np.asarray(gh), np.asarray(rh)) < 1e-2


def test_convolve_real_vjp_learned_filter(rng, backend):
    """The matched-filter training shape: gradient w.r.t. a real-signal
    bank's filter response."""
    x = _rdata(rng, (B, N))
    h = _cdata(rng, (N // 2 + 1,))

    def loss(h_):
        y = api.convolve_real(x, h_, backend=backend)
        return jnp.sum(y ** 2)

    def loss_ref(h_):
        y = jnp.fft.irfft(jnp.fft.rfft(x) * h_, N)
        return jnp.sum(y ** 2)

    gh = jax.grad(loss)(h)
    rh = jax.grad(loss_ref)(h)
    assert max_abs_err(np.asarray(gh), np.asarray(rh)) < 1e-2


def test_grad_through_dct_and_hilbert(rng):
    """Composition: modules built on the api primitives differentiate
    end-to-end with no extra rules."""
    import sys
    import smfft.dct  # noqa: F401
    D = sys.modules["smfft.dct"]
    from smfft import signal as sig

    x = _rdata(rng, (2, N))
    g1 = jax.grad(lambda v: jnp.sum(D.dct(v, type=2) ** 2))(x)
    assert np.all(np.isfinite(np.asarray(g1)))
    g2 = jax.grad(lambda v: jnp.sum(jnp.abs(sig.hilbert(v)) ** 2))(x)
    # d/dx sum |analytic|^2: check against finite jnp composition
    def ref(v):
        n = v.shape[-1]
        m = np.zeros(n, np.float32)
        m[0] = 1.0
        m[1:n // 2] = 2.0
        m[n // 2] = 1.0
        return jnp.sum(jnp.abs(jnp.fft.ifft(jnp.fft.fft(v) * m)) ** 2)
    g2_ref = jax.grad(lambda v: ref(v))(x)
    assert max_abs_err(np.asarray(g2), np.asarray(g2_ref)) < 2e-2


def test_fft_unordered_vjp_is_permuted_vjp(rng):
    """The digit-reversed output differentiates like the ordered one with
    its output permuted: vjp_unordered(g) = vjp_ordered(g[inv_perm])."""
    from smfft import params as P
    from smfft.ops.matmul_fft import digit_reverse_indices
    x = _cdata(rng, (B, N))
    g = _cdata(rng, (B, N))
    perm = digit_reverse_indices(N, P.get_factorization(N))
    _, vjp_u = jax.vjp(lambda v: api.fft(v, ordered=False), x)
    _, vjp_ref = jax.vjp(jnp.fft.fft, x)
    # unordered[perm[k]] = ordered[k], so ordered-cotangent[k] = g[perm[k]]
    assert max_abs_err(np.asarray(vjp_u(g)[0]),
                       np.asarray(vjp_ref(g[:, perm])[0])) < 1e-3
