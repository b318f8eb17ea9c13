"""Spectral-analysis layer: power spectrum + periodogram / Welch / STFT /
spectrogram wrappers (signal.py) vs numpy/scipy oracles."""

import numpy as np
import jax.numpy as jnp
import pytest

from smfft import signal as SG


def np_power(x, w=None):
    """Oracle: one-sided power bins 0..n/2-1, slot 0 = DC^2."""
    xw = x if w is None else x * w
    spec = np.fft.rfft(xw.astype(np.float64), axis=-1)
    return np.abs(spec[..., : x.shape[-1] // 2]) ** 2


@pytest.mark.parametrize("backend", ["jnp", "xla"])
@pytest.mark.parametrize("n", [256, 1024])
def test_power_spectrum_vs_numpy(rng, n, backend):
    x = (rng.random((16, n)) - 0.5).astype(np.float32)
    got = np.asarray(SG.power_spectrum(jnp.array(x), backend=backend))
    want = np_power(x)
    assert got.shape == (16, n // 2)
    scale = max(1.0, float(np.max(want)))
    assert np.max(np.abs(got - want)) / scale < 1e-5


def test_power_spectrum_windowed(rng):
    n = 512
    x = (rng.random((8, n)) - 0.5).astype(np.float32)
    w = np.asarray(SG.get_window("hann", n))
    got = np.asarray(SG.power_spectrum(jnp.array(x), window=jnp.array(w)))
    want = np_power(x, w)
    scale = max(1.0, float(np.max(want)))
    assert np.max(np.abs(got - want)) / scale < 1e-5


def test_power_spectrum_bad_sizes():
    with pytest.raises(ValueError, match="wrong FFT length"):
        SG.power_spectrum(jnp.zeros((8, 192), jnp.float32))
    with pytest.raises(ValueError, match="wrong FFT length"):
        SG.power_spectrum(jnp.zeros((8, 128), jnp.float32))


def test_power_spectrum_backends_agree(rng):
    n = 256
    x = (rng.random((4, n)) - 0.5).astype(np.float32)
    a = np.asarray(SG.power_spectrum(jnp.array(x), backend="jnp"))
    b = np.asarray(SG.power_spectrum(jnp.array(x), backend="xla"))
    assert a.shape == b.shape == (4, n // 2)
    assert np.max(np.abs(a - b)) < 1e-4


def test_get_window_vs_scipy():
    ss = pytest.importorskip("scipy.signal")
    for name in ("boxcar", "hann", "hamming", "blackman", "bartlett"):
        got = np.asarray(SG.get_window(name, 256))
        want = ss.get_window(name, 256, fftbins=True)
        assert np.max(np.abs(got - want)) < 1e-6, name
    got = np.asarray(SG.get_window(("kaiser", 8.6), 256))
    want = ss.get_window(("kaiser", 8.6), 256, fftbins=True)
    assert np.max(np.abs(got - want)) < 1e-5


def test_periodogram_vs_scipy(rng):
    ss = pytest.importorskip("scipy.signal")
    n = 1024
    x = (rng.random((3, n)) - 0.5).astype(np.float32)
    f, pxx = SG.periodogram(jnp.array(x), fs=100.0, window="hann")
    f_ref, pxx_ref = ss.periodogram(x.astype(np.float64), fs=100.0,
                                    window="hann", axis=-1)
    assert np.allclose(np.asarray(f), f_ref[: n // 2], atol=1e-5)
    scale = float(np.max(pxx_ref))
    assert (np.max(np.abs(np.asarray(pxx) - pxx_ref[..., : n // 2]))
            / scale < 1e-5)


def test_periodogram_spectrum_scaling(rng):
    ss = pytest.importorskip("scipy.signal")
    n = 512
    x = (rng.random(n) - 0.5).astype(np.float32)
    _, pxx = SG.periodogram(jnp.array(x), window="hamming",
                            scaling="spectrum")
    _, pxx_ref = ss.periodogram(x.astype(np.float64), window="hamming",
                                scaling="spectrum")
    scale = float(np.max(pxx_ref))
    assert (np.max(np.abs(np.asarray(pxx) - pxx_ref[: n // 2]))
            / scale < 1e-5)


def test_welch_vs_scipy(rng):
    ss = pytest.importorskip("scipy.signal")
    fs, n = 1000.0, 512
    t = np.arange(8192) / fs
    x = (np.sin(2 * np.pi * 123.0 * t)
         + 0.1 * rng.standard_normal(t.size)).astype(np.float32)
    f, pxx = SG.welch(jnp.array(x), fs=fs, nperseg=n)
    f_ref, pxx_ref = ss.welch(x.astype(np.float64), fs=fs, nperseg=n)
    assert np.allclose(np.asarray(f), f_ref[: n // 2], atol=1e-5)
    scale = float(np.max(pxx_ref))
    assert (np.max(np.abs(np.asarray(pxx) - pxx_ref[: n // 2]))
            / scale < 1e-4)
    # the 123 Hz tone lands in the right bin
    assert abs(float(f[int(np.argmax(np.asarray(pxx)))]) - 123.0) < fs / n


def test_spectrogram_shapes_and_tone(rng):
    fs, n = 256.0, 256
    t = np.arange(4096) / fs
    x = np.sin(2 * np.pi * 60.0 * t).astype(np.float32)
    f, times, sxx = SG.spectrogram(jnp.array(x), fs=fs, nperseg=n)
    frames = 1 + (x.size - n) // (n // 2)
    assert np.asarray(sxx).shape == (frames, n // 2)
    assert times.shape == (frames,)
    peak = np.asarray(f)[np.argmax(np.asarray(sxx), axis=-1)]
    assert np.all(np.abs(peak - 60.0) < fs / n)


def test_stft_vs_manual(rng):
    n, hop = 256, 64
    x = (rng.random(2048) - 0.5).astype(np.float32)
    z = np.asarray(SG.stft(jnp.array(x), n_fft=n, hop_length=hop))
    w = np.asarray(SG.get_window("hann", n), np.float64)
    frames = 1 + (x.size - n) // hop
    assert z.shape == (frames, n // 2 + 1)
    for fidx in (0, frames // 2, frames - 1):
        seg = x[fidx * hop: fidx * hop + n].astype(np.float64) * w
        want = np.fft.rfft(seg)
        assert np.max(np.abs(z[fidx] - want)) < 1e-4


def test_stft_istft_roundtrip(rng):
    n, hop = 256, 64
    x = (rng.random((2, 2048)) - 0.5).astype(np.float32)
    z = SG.stft(jnp.array(x), n_fft=n, hop_length=hop)
    y = np.asarray(SG.istft(z, n_fft=n, hop_length=hop,
                            length=x.shape[-1]))
    # exact wherever the window-square overlap covers (interior)
    assert np.max(np.abs(y[:, n:-n] - x[:, n:-n])) < 1e-4
