"""Analytic signal / correlation / resampling (smfft.signal) and
arbitrary-length real transforms (smfft.bluestein) vs scipy/numpy
float64 oracles."""

import numpy as np
import jax.numpy as jnp
import pytest

import smfft as S

from conftest import max_abs_err


# --------------------------------------------------------------------------
# hilbert / envelope
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [256, 1024])
def test_hilbert_vs_scipy(rng, n):
    import scipy.signal as sps
    x = (rng.random((3, n)) * 2 - 1).astype(np.float32)
    got = np.asarray(S.hilbert(jnp.array(x)))
    ref = sps.hilbert(x.astype(np.float64), axis=-1)
    assert got.shape == (3, n)
    assert max_abs_err(got, ref) < 1e-3


def test_envelope_of_tone(rng):
    # AM tone: envelope of a * cos(w t) is |a| for any carrier bin
    n = 512
    t = np.arange(n)
    a = 1.0 + 0.5 * np.cos(2 * np.pi * 3 * t / n)
    x = (a * np.cos(2 * np.pi * 40 * t / n)).astype(np.float32)
    env = np.asarray(S.envelope(jnp.array(x)))
    # edges ring a little; compare the interior
    assert np.max(np.abs(env[32:-32] - a[32:-32])) < 2e-2


def test_hilbert_rejects_complex_and_bad_n():
    with pytest.raises(ValueError):
        S.hilbert(jnp.zeros((2, 100)))
    with pytest.raises(ValueError):
        S.hilbert(jnp.zeros((2, 256), jnp.complex64))


# --------------------------------------------------------------------------
# fftcorrelate
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_fftcorrelate_real_vs_scipy(rng, mode):
    import scipy.signal as sps
    t, k = 3000, 65
    x = (rng.random(t) * 2 - 1).astype(np.float32)
    h = (rng.random(k) * 2 - 1).astype(np.float32)
    got = np.asarray(S.fftcorrelate(jnp.array(x), jnp.array(h), mode=mode))
    ref = sps.correlate(x.astype(np.float64), h.astype(np.float64),
                        mode=mode)
    assert got.shape == ref.shape
    assert max_abs_err(got, ref) < 1e-3


def test_fftcorrelate_matched_filter_peak(rng):
    # correlating a signal with an embedded template peaks at the offset
    t, k, off = 2000, 128, 700
    h = (rng.random(k) * 2 - 1).astype(np.float32)
    x = (0.05 * rng.random(t)).astype(np.float32)
    x[off:off + k] += h
    y = np.asarray(S.fftcorrelate(jnp.array(x), jnp.array(h),
                                  mode="valid"))
    assert int(np.argmax(y)) == off


def test_oaconvolve_alias(rng):
    assert S.oaconvolve is S.fftconvolve


# --------------------------------------------------------------------------
# resample
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,num", [(512, 256), (512, 1024), (500, 300),
                                   (300, 500), (512, 300), (100, 64)])
def test_resample_vs_scipy(rng, n, num):
    import scipy.signal as sps
    x = (rng.random((2, n)) * 2 - 1).astype(np.float32)
    got = np.asarray(S.resample(jnp.array(x), num))
    ref = sps.resample(x.astype(np.float64), num, axis=-1)
    assert got.shape == (2, num)
    assert got.dtype == np.float32
    assert max_abs_err(got, ref) < 1e-3


def test_resample_complex_and_axis(rng):
    import scipy.signal as sps
    n, num = 256, 180
    x = (rng.random((n, 3)) + 1j * rng.random((n, 3)) - 0.5 - 0.5j
         ).astype(np.complex64)
    got = np.asarray(S.resample(jnp.array(x), num, axis=0))
    ref = sps.resample(x.astype(np.complex128), num, axis=0)
    assert got.shape == (num, 3)
    assert max_abs_err(got, ref) < 1e-3


# --------------------------------------------------------------------------
# rfft_any / irfft_any
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [100, 601, 1000, 512])
def test_rfft_any_vs_numpy(rng, n):
    x = (rng.random((3, n)) * 2 - 1).astype(np.float32)
    got = np.asarray(S.rfft_any(jnp.array(x)))
    ref = np.fft.rfft(x.astype(np.float64))
    assert got.shape == (3, n // 2 + 1)
    assert max_abs_err(got, ref) < 1e-3 * np.sqrt(n)


@pytest.mark.parametrize("n", [100, 601, 512])
def test_irfft_any_roundtrip(rng, n):
    x = (rng.random((2, n)) * 2 - 1).astype(np.float32)
    spec = S.rfft_any(jnp.array(x))
    back = np.asarray(S.irfft_any(spec, n=n))
    assert back.shape == (2, n)
    assert max_abs_err(back, x) < 1e-3


def test_irfft_any_default_length_and_errors(rng):
    x = (rng.random((2, 600)) * 2 - 1).astype(np.float32)
    spec = S.rfft_any(jnp.array(x))          # (2, 301)
    back = np.asarray(S.irfft_any(spec))     # n defaults to 600
    assert back.shape == (2, 600)
    with pytest.raises(ValueError):
        S.irfft_any(spec, n=800)             # too few bins
    with pytest.raises(ValueError):
        S.rfft_any(jnp.zeros((2, 64), jnp.complex64))
