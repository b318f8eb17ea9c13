"""Spectral convolution tests: api.convolve / api.convolve_real and
their (M, ...) template-bank forms.

The convolution theorem oracle is numpy: ifft(fft(x) * H).  Covers sizes
on the jnp.fft route and the matmul engine, the api wrapper on every
backend, precision tiers, and a time-domain circular-convolution
cross-check.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import smfft as S

from conftest import max_abs_err

ENGINES = ["jnp", "xla"]


def rand_c(rng, *shape):
    return (rng.random(shape) + 1j * rng.random(shape)
            - 0.5 - 0.5j).astype(np.complex64)


def to_dev(x):
    return jax.lax.complex(jnp.array(np.ascontiguousarray(x.real)),
                           jnp.array(np.ascontiguousarray(x.imag)))


def oracle(x, h_freq):
    f = np.fft.fft(x.astype(np.complex128))
    return np.fft.ifft(f * h_freq.astype(np.complex128))


def tol(n):
    return 5e-7 * n ** 0.75 * 8


@pytest.mark.parametrize("backend", ENGINES)
@pytest.mark.parametrize("n", [32, 64, 128, 512, 2048])
def test_convolve_vs_numpy(rng, n, backend):
    b = max(2, 256 // n)
    x = rand_c(rng, b, n)
    h = rand_c(rng, n)
    got = np.asarray(S.convolve(to_dev(x), to_dev(h), backend=backend))
    assert max_abs_err(got, oracle(x, h)) < tol(n)


def test_identity_filter_roundtrip(rng):
    """H == 1 everywhere -> convolution is the identity (checks the 1/N
    normalization end to end)."""
    n, b = 1024, 16
    x = rand_c(rng, b, n)
    h = np.ones(n, np.complex64)
    got = np.asarray(S.convolve(to_dev(x), to_dev(h)))
    assert max_abs_err(got, x) < tol(n)


def test_time_domain_circular_convolution(rng):
    """api.convolve(x, fft(h_time)) equals the O(N^2) circular
    convolution sum — the actual signal-processing contract."""
    n, b = 256, 8
    x = rand_c(rng, b, n)
    h_t = rand_c(rng, n)
    h_f = np.fft.fft(h_t.astype(np.complex128)).astype(np.complex64)
    got = np.asarray(S.convolve(to_dev(x), to_dev(h_f), backend="jnp"))
    idx = (np.arange(n)[:, None] - np.arange(n)[None, :]) % n
    ref = np.einsum("bk,nk->bn", x.astype(np.complex128),
                    h_t.astype(np.complex128)[idx])
    assert max_abs_err(got, ref) < tol(n) * 4


@pytest.mark.parametrize("backend", ["xla", "spec", "jnp"])
def test_backend_fallbacks_agree(rng, backend):
    n, b = 512, 8
    x = rand_c(rng, b, n)
    h = rand_c(rng, n)
    got = np.asarray(S.convolve(to_dev(x), to_dev(h), backend=backend))
    assert max_abs_err(got, oracle(x, h)) < tol(n)


def test_fast_precision_runs(rng):
    n, b = 512, 8
    x = rand_c(rng, b, n)
    h = rand_c(rng, n)
    got = np.asarray(S.convolve(to_dev(x), to_dev(h), backend="xla",
                                precision="fast"))
    # fast tier: throughput knob, loose gate (two cores + product)
    assert max_abs_err(got, oracle(x, h)) < 5e-3


def test_wrong_shapes_raise(rng):
    x = to_dev(rand_c(rng, 8, 512))
    with pytest.raises(ValueError, match="wrong FFT length"):
        S.convolve(to_dev(rand_c(rng, 8, 100)), to_dev(rand_c(rng, 100)))
    with pytest.raises(ValueError, match="natural-order frequency"):
        S.convolve(x, to_dev(rand_c(rng, 256)))


@pytest.mark.parametrize("backend", ENGINES)
@pytest.mark.parametrize("n,m", [(64, 2), (512, 3)])
def test_filter_bank(rng, n, m, backend):
    """Bank form: every signal against every template, forward FFT
    computed once per signal."""
    b = max(8, 128 // n * 2)
    x = rand_c(rng, b, n)
    hs = rand_c(rng, m, n)
    got = np.asarray(S.convolve(to_dev(x), to_dev(hs), backend=backend))
    assert got.shape == (m, b, n)
    for j in range(m):
        assert max_abs_err(got[j], oracle(x, hs[j])) < tol(n)


def test_filter_bank_api_and_fallback(rng):
    n, m, b = 256, 2, 8
    x = rand_c(rng, b, n)
    hs = rand_c(rng, m, n)
    got_p = np.asarray(S.convolve(to_dev(x), to_dev(hs), backend="jnp"))
    got_x = np.asarray(S.convolve(to_dev(x), to_dev(hs), backend="xla"))
    assert got_p.shape == got_x.shape == (m, b, n)
    for j in range(m):
        ref = oracle(x, hs[j])
        assert max_abs_err(got_p[j], ref) < tol(n)
        assert max_abs_err(got_x[j], ref) < tol(n)


def real_oracle(x, h_half):
    return np.fft.irfft(np.fft.rfft(x.astype(np.float64))
                        * h_half.astype(np.complex128), x.shape[-1])


@pytest.mark.parametrize("backend", ENGINES)
@pytest.mark.parametrize("n", [256, 512, 2048])
def test_real_convolve_vs_numpy(rng, n, backend):
    """r2c -> half-spectrum multiply -> c2r."""
    b = 16
    x = (rng.random((b, n)) * 2 - 1).astype(np.float32)
    h_t = (rng.random(n) * 2 - 1).astype(np.float32)
    h = np.fft.rfft(h_t.astype(np.float64)).astype(np.complex64)
    got = np.asarray(S.convolve_real(jnp.array(x), to_dev(h),
                                     backend=backend))
    assert got.shape == (b, n)
    assert max_abs_err(got, real_oracle(x, h)) < tol(n)


def test_real_convolve_identity(rng):
    """H == 1 -> identity (checks slot-0 (DC, Nyquist) handling and the
    1/(N/2) folding)."""
    n, b = 1024, 8
    x = (rng.random((b, n)) * 2 - 1).astype(np.float32)
    h = np.ones(n // 2 + 1, np.complex64)
    got = np.asarray(S.convolve_real(jnp.array(x), to_dev(h)))
    assert max_abs_err(got, x) < tol(n)


def test_real_convolve_api_and_fallback(rng):
    n, b = 512, 8
    x = (rng.random((b, n)) * 2 - 1).astype(np.float32)
    h_t = (rng.random(n) * 2 - 1).astype(np.float32)
    h = np.fft.rfft(h_t.astype(np.float64)).astype(np.complex64)
    ref = real_oracle(x, h)
    got_p = np.asarray(S.convolve_real(jnp.array(x), to_dev(h),
                                       backend="jnp"))
    got_x = np.asarray(S.convolve_real(jnp.array(x), to_dev(h),
                                       backend="xla"))
    assert max_abs_err(got_p, ref) < tol(n)
    assert max_abs_err(got_x, ref) < tol(n)
    with pytest.raises(ValueError, match="rfft-style"):
        S.convolve_real(jnp.array(x), to_dev(h[:-1]))
    with pytest.raises(ValueError, match="wrong FFT length"):
        S.convolve_real(jnp.array(x[:, :100]), to_dev(h))


def test_real_filter_bank(rng):
    """Real bank: r2c once per signal, m half-spectrum products + c2r."""
    n, m, b = 512, 3, 16
    x = (rng.random((b, n)) * 2 - 1).astype(np.float32)
    hts = (rng.random((m, n)) * 2 - 1).astype(np.float32)
    hs = np.fft.rfft(hts.astype(np.float64)).astype(np.complex64)
    got = np.asarray(S.convolve_real(jnp.array(x), to_dev(hs),
                                     backend="jnp"))
    got_x = np.asarray(S.convolve_real(jnp.array(x), to_dev(hs),
                                       backend="xla"))
    assert got.shape == got_x.shape == (m, b, n)
    for j in range(m):
        ref = real_oracle(x, hs[j])
        assert max_abs_err(got[j], ref) < tol(n)
        assert max_abs_err(got_x[j], ref) < tol(n)


def test_odd_batch_padding(rng):
    """Odd row batches and extra leading axes keep their shape."""
    n, b = 256, 13
    x = rand_c(rng, b, n)
    h = rand_c(rng, n)
    got = np.asarray(S.convolve(to_dev(x), to_dev(h)))
    assert got.shape == (b, n)
    assert max_abs_err(got, oracle(x, h)) < tol(n)
