"""Arbitrary-length FFT (smfft.bluestein) vs the numpy.fft oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

from smfft import bluestein


@pytest.fixture
def rng():
    return np.random.default_rng(7)


@pytest.mark.parametrize("n", [3, 7, 12, 100, 129, 500, 1000, 1536, 4097])
def test_fft_any_matches_numpy(rng, n):
    x = (rng.random((4, n)) + 1j * rng.random((4, n))
         - 0.5 - 0.5j).astype(np.complex64)
    got = np.asarray(bluestein.fft_any(jnp.asarray(x)))
    want = np.fft.fft(x.astype(np.complex128))
    tol = 3e-7 * n ** 0.75 * 8 + 1e-5
    assert np.max(np.abs(got - want)) < tol, n


def test_fft_any_power_of_two_direct(rng):
    # supported sizes go straight to api.fft (same values)
    x = (rng.random((2, 256)) + 1j * rng.random((2, 256))
         - 0.5 - 0.5j).astype(np.complex64)
    got = np.asarray(bluestein.fft_any(jnp.asarray(x)))
    want = np.fft.fft(x.astype(np.complex128))
    assert np.max(np.abs(got - want)) < 1e-4


def test_fft_any_n1():
    x = jnp.asarray(np.array([[3.0 + 1j]], np.complex64))
    assert np.allclose(np.asarray(bluestein.fft_any(x)), [[3.0 + 1j]])


@pytest.mark.parametrize("n", [5, 100, 729])
def test_ifft_any_roundtrip(rng, n):
    x = (rng.random((3, n)) + 1j * rng.random((3, n))
         - 0.5 - 0.5j).astype(np.complex64)
    y = bluestein.ifft_any(bluestein.fft_any(jnp.asarray(x)))
    assert np.max(np.abs(np.asarray(y) - x)) < 1e-4, n


def test_fft_any_too_long_raises(rng):
    x = jnp.zeros((1, 9000), jnp.complex64)
    with pytest.raises(ValueError, match="wrong FFT length"):
        bluestein.fft_any(x)


def test_czt_default_is_dft(rng):
    n = 60
    x = (rng.random((2, n)) + 1j * rng.random((2, n))
         - 0.5 - 0.5j).astype(np.complex64)
    got = np.asarray(bluestein.czt(jnp.asarray(x)))
    want = np.fft.fft(x.astype(np.complex128))
    assert np.max(np.abs(got - want)) < 1e-4


def test_czt_zoom_band(rng):
    # zoom-DFT: m points over a sub-band starting at bin 10 of a
    # length-128 DFT grid — czt(a=W_128^{-10}, w=e^{-2pi i/128})
    n, m, nfft, k0 = 96, 32, 128, 10
    x = (rng.random((n,)) + 1j * rng.random((n,)) - 0.5 - 0.5j
         ).astype(np.complex64)
    w = np.exp(-2j * np.pi / nfft)
    a = np.exp(2j * np.pi * k0 / nfft)
    got = np.asarray(bluestein.czt(jnp.asarray(x), m=m, w=w, a=a))
    ks = np.arange(m) + k0
    want = np.array([np.sum(x.astype(np.complex128)
                            * np.exp(-2j * np.pi * k * np.arange(n) / nfft))
                     for k in ks])
    assert np.max(np.abs(got - want)) < 1e-3


@pytest.mark.parametrize("n", [100, 1000])
def test_planar_bluestein_padded_rows(rng, n):
    """planar.fft_any on 128-lane padded rows: Bluestein on the padded
    contract, padded output lanes exactly zero."""
    from smfft import planar
    np_ = -(-n // 128) * 128
    x = (rng.random((12, n)) + 1j * rng.random((12, n))
         - 0.5 - 0.5j).astype(np.complex64)
    vr = np.zeros((12, np_), np.float32)
    vi = np.zeros((12, np_), np.float32)
    vr[:, :n], vi[:, :n] = x.real, x.imag
    o_r, o_i = planar.fft_any(jnp.asarray(vr), jnp.asarray(vi), n=n)
    got = np.asarray(o_r) + 1j * np.asarray(o_i)
    want = np.fft.fft(x.astype(np.complex128))
    assert np.max(np.abs(got[:, :n] - want)) < 1e-3
    assert np.max(np.abs(got[:, n:])) == 0.0   # padded lanes zeroed


def test_czt_spiral_contour(rng):
    # |w| != 1 spiral (scipy.signal.czt semantics)
    n, m = 40, 25
    x = (rng.random((n,)) - 0.5).astype(np.complex64)
    w = 1.001 * np.exp(-2j * np.pi / 50)
    a = 0.998 * np.exp(2j * np.pi * 0.03)
    got = np.asarray(bluestein.czt(jnp.asarray(x), m=m, w=w, a=a))
    j = np.arange(n)
    want = np.array([np.sum(x.astype(np.complex128) * (a ** -j) * w ** (j * k))
                     for k in range(m)])
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-4


def test_zoom_fft_vs_scipy(rng):
    import scipy.signal as sps
    from smfft.bluestein import zoom_fft

    n, m = 400, 128
    x = (rng.random((3, n)) + 1j * rng.random((3, n)) - 0.5 - 0.5j
         ).astype(np.complex64)
    got = np.asarray(zoom_fft(jnp.array(x), [0.1, 0.4], m=m))
    ref = sps.zoom_fft(x.astype(np.complex128), [0.1, 0.4], m=m)
    assert got.shape == (3, m)
    assert np.max(np.abs(got - ref)) < 1e-2


def test_zoom_fft_full_band_is_dft(rng):
    from smfft.bluestein import zoom_fft

    n = 100
    x = (rng.random((2, n)) + 1j * rng.random((2, n)) - 0.5 - 0.5j
         ).astype(np.complex64)
    got = np.asarray(zoom_fft(jnp.array(x), 2.0, m=n))
    ref = np.fft.fft(x.astype(np.complex128))
    assert np.max(np.abs(got - ref)) < 1e-2
