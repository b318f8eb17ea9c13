"""Overlap-save linear convolution (smfft.signal.fftconvolve) vs
numpy.convolve."""

import numpy as np
import jax.numpy as jnp
import pytest

import smfft as S

from conftest import max_abs_err


def to_dev(x):
    import jax
    return jax.lax.complex(jnp.array(np.ascontiguousarray(x.real)),
                           jnp.array(np.ascontiguousarray(x.imag)))


@pytest.mark.parametrize("t,k", [(5000, 33), (1000, 250)])
def test_real_full_vs_numpy(rng, t, k):
    x = (rng.random(t) * 2 - 1).astype(np.float32)
    h = (rng.random(k) * 2 - 1).astype(np.float32)
    got = np.asarray(S.fftconvolve(jnp.array(x), jnp.array(h)))
    ref = np.convolve(x.astype(np.float64), h.astype(np.float64))
    assert got.shape == (t + k - 1,)
    assert max_abs_err(got, ref) < 1e-3


def test_complex_full_vs_numpy(rng):
    t, k = 3000, 100
    x = (rng.random(t) + 1j * rng.random(t) - 0.5 - 0.5j
         ).astype(np.complex64)
    h = (rng.random(k) + 1j * rng.random(k) - 0.5 - 0.5j
         ).astype(np.complex64)
    got = np.asarray(S.fftconvolve(to_dev(x), to_dev(h)))
    ref = np.convolve(x.astype(np.complex128), h.astype(np.complex128))
    assert max_abs_err(got, ref) < 1e-3


def test_batched_and_modes(rng):
    b, t, k = 3, 2000, 65
    x = (rng.random((b, t)) * 2 - 1).astype(np.float32)
    h = (rng.random(k) * 2 - 1).astype(np.float32)
    full = np.asarray(S.fftconvolve(jnp.array(x), jnp.array(h)))
    same = np.asarray(S.fftconvolve(jnp.array(x), jnp.array(h),
                                    mode="same"))
    valid = np.asarray(S.fftconvolve(jnp.array(x), jnp.array(h),
                                     mode="valid"))
    assert full.shape == (b, t + k - 1)
    assert same.shape == (b, t)
    assert valid.shape == (b, t - k + 1)
    for j in range(b):
        ref = np.convolve(x[j].astype(np.float64), h.astype(np.float64))
        assert max_abs_err(full[j], ref) < 1e-3
        assert max_abs_err(same[j], np.convolve(
            x[j].astype(np.float64), h.astype(np.float64),
            mode="same")) < 1e-3
        assert max_abs_err(valid[j], np.convolve(
            x[j].astype(np.float64), h.astype(np.float64),
            mode="valid")) < 1e-3


def test_explicit_nfft_and_errors(rng):
    t, k = 1500, 17
    x = (rng.random(t) * 2 - 1).astype(np.float32)
    h = (rng.random(k) * 2 - 1).astype(np.float32)
    got = np.asarray(S.fftconvolve(jnp.array(x), jnp.array(h),
                                   n_fft=512))
    ref = np.convolve(x.astype(np.float64), h.astype(np.float64))
    assert max_abs_err(got, ref) < 1e-3
    with pytest.raises(ValueError, match="unsupported"):
        S.fftconvolve(jnp.array(x), jnp.array(h), n_fft=300)
    with pytest.raises(ValueError, match="mode"):
        S.fftconvolve(jnp.array(x), jnp.array(h), mode="bogus")


def test_short_signal_shorter_than_frame(rng):
    """T smaller than one frame still works (single padded frame)."""
    t, k = 100, 9
    x = (rng.random(t) * 2 - 1).astype(np.float32)
    h = (rng.random(k) * 2 - 1).astype(np.float32)
    got = np.asarray(S.fftconvolve(jnp.array(x), jnp.array(h)))
    ref = np.convolve(x.astype(np.float64), h.astype(np.float64))
    assert max_abs_err(got, ref) < 1e-3
