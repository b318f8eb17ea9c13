"""Native harness tests: C library builds, matches the numpy fallback, and
implements the reference's error-metric semantics exactly."""

import numpy as np
import pytest

from smfft import native


def test_library_builds_and_loads():
    lib = native.get_lib()
    assert lib is not None, "g++ build of libsmfft_host.so failed"


def test_generate_uniform_deterministic():
    a = native.generate_uniform(1000, seed=42)
    b = native.generate_uniform(1000, seed=42)
    c = native.generate_uniform(1000, seed=43)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.min() >= -0.5 and a.max() <= 0.5


def test_two_tone_spectrum():
    """Two-tone fixture has energy exactly at f1, f2 (resurrecting the
    reference's dead Generate_signal as a live, checked fixture)."""
    sig = native.generate_two_tone(2, 512, f1=17.0, a1=1.0, f2=41.0, a2=0.5)
    spec = np.abs(np.fft.rfft(sig[0].astype(np.float64)))
    peaks = set(np.argsort(spec)[-2:])
    assert peaks == {17, 41}


def test_hybrid_metric_absolute_below_10():
    got = np.array([1.0 + 0j], np.complex64)
    want = np.array([1.0001 + 0j], np.complex64)
    st = native.compare(got, want, tolerance=1e-4)
    assert abs(st["max_error"] - 1e-4) < 1e-6


def test_hybrid_metric_decade_relative_above_10():
    """get_error divides by the decade only when |value| > 10
    (FFT.c:23-49): an absolute error of 0.05 on a value of 500 counts as
    0.05/100 = 5e-4."""
    got = np.array([500.05 + 0j], np.complex64)
    want = np.array([500.0 + 0j], np.complex64)
    st = native.compare(got, want, tolerance=1e-4)
    assert abs(st["max_error"] - 5e-4) < 1e-5
    assert st["error_count"] == 1


def test_compare_counts_and_stats():
    want = (np.arange(100) + 0j).astype(np.complex64)
    got = want.copy()
    got[3] += 0.01     # error 1e-2 > 1e-4
    got[50] += 1e-6    # below tolerance
    st = native.compare(got, want)
    assert st["error_count"] == 1
    assert st["max_error"] == pytest.approx(0.01, rel=1e-3)


def test_native_matches_numpy_fallback():
    rng = np.random.default_rng(0)
    want = (rng.random(512) * 40 - 20 + 1j * (rng.random(512) * 40 - 20)
            ).astype(np.complex64)
    got = want + (rng.random(512) * 2e-4).astype(np.float32)
    st_native = native.compare(got, want)
    # force numpy path
    lib = native._lib
    native._lib, native._tried = None, True
    try:
        st_numpy = native.compare(got, want)
    finally:
        native._lib, native._tried = lib, True
    assert st_native["max_error"] == pytest.approx(st_numpy["max_error"], rel=1e-5)
    assert st_native["error_count"] == st_numpy["error_count"]


def test_compare_r2c_packed_layout():
    rng = np.random.default_rng(1)
    n, b = 256, 8
    x = (rng.random((b, n)) - 0.5).astype(np.float64)
    full = np.fft.rfft(x).astype(np.complex64)          # (b, L+1)
    packed = np.concatenate(
        [full[:, :1].real + 1j * full[:, n // 2:].real, full[:, 1:n // 2]],
        axis=1).astype(np.complex64)
    st = native.compare_r2c_packed(packed, full)
    assert st["error_count"] == 0
    # corrupt the Nyquist slot -> detected
    packed[0, 0] += 1j * 0.1
    st = native.compare_r2c_packed(packed, full)
    assert st["error_count"] >= 1


def test_compare_real_normalization():
    """C2R compare divides got by N/2 and golden by N (FFT.c:170-171)."""
    x = np.linspace(-1, 1, 128).astype(np.float32)
    got = x * 64          # unnormalized kernel output, scale N/2
    want = x * 128        # unnormalized golden, scale N
    st = native.compare_real(got, want, got_scale=64, want_scale=128)
    assert st["max_error"] < 1e-6
