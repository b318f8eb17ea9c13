"""Mathematical FFT properties — verification beyond the reference's
element-wise golden compare (SURVEY.md §4): linearity, Parseval's
theorem, the shift theorem, and impulse/constant responses, checked on
the product api paths."""

import numpy as np
import jax.numpy as jnp
import pytest

import smfft as S

from conftest import max_abs_err


def rand_c(rng, b, n):
    return (rng.random((b, n)) + 1j * rng.random((b, n))
            - 0.5 - 0.5j).astype(np.complex64)


@pytest.mark.parametrize("backend", ["xla", "jnp"])
def test_linearity(rng, backend):
    n = 512
    x, y = rand_c(rng, 16, n), rand_c(rng, 16, n)
    a, b = 1.7, -0.3 + 0.9j
    lhs = np.asarray(S.fft(jnp.array(a * x + b * y), backend=backend))
    rhs = (a * np.asarray(S.fft(jnp.array(x), backend=backend))
           + b * np.asarray(S.fft(jnp.array(y), backend=backend)))
    assert max_abs_err(lhs, rhs) < 1e-3


@pytest.mark.parametrize("n", [128, 1024])
def test_parseval(rng, n):
    x = rand_c(rng, 16, n)
    X = np.asarray(S.fft(jnp.array(x), backend="xla"))
    energy_t = np.sum(np.abs(x.astype(np.complex128)) ** 2, axis=-1)
    energy_f = np.sum(np.abs(X.astype(np.complex128)) ** 2, axis=-1) / n
    assert np.max(np.abs(energy_t - energy_f) / energy_t) < 1e-5


def test_shift_theorem(rng):
    n, s = 256, 37
    x = rand_c(rng, 8, n)
    X = np.asarray(S.fft(jnp.array(x), backend="xla")).astype(np.complex128)
    Xs = np.asarray(S.fft(jnp.array(np.roll(x, s, axis=-1)),
                          backend="xla")).astype(np.complex128)
    k = np.arange(n)
    phase = np.exp(-2j * np.pi * k * s / n)
    assert np.max(np.abs(Xs - X * phase)) < 1e-3


def test_impulse_and_constant():
    n = 512
    imp = np.zeros((8, n), np.complex64)
    imp[:, 0] = 1.0
    X = np.asarray(S.fft(jnp.array(imp), backend="xla"))
    assert max_abs_err(X, np.ones((8, n))) < 1e-5
    const = np.ones((8, n), np.complex64)
    Xc = np.asarray(S.fft(jnp.array(const), backend="xla"))
    want = np.zeros((8, n))
    want[:, 0] = n
    assert max_abs_err(Xc, want) < 1e-4


def test_real_signal_hermitian_symmetry(rng):
    n = 1024
    xr = (rng.random((8, n)) - 0.5).astype(np.float32)
    spec = np.asarray(S.rfft(jnp.array(xr), backend="xla"))
    full = np.asarray(S.fft(jnp.array(xr.astype(np.complex64)),
                            backend="xla"))
    # rfft output == first half of the full spectrum of the real signal
    assert max_abs_err(spec, full[:, :n // 2 + 1]) < 1e-3
    # Hermitian symmetry of the full spectrum
    assert max_abs_err(full[:, 1:], np.conj(full[:, 1:][:, ::-1])) < 1e-3
