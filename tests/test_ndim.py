"""N-D transforms (smfft.ndim) vs the numpy.fft float64 oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

from smfft import ndim


def _tol(*ns):
    return 2e-7 * float(np.prod([n ** 0.75 for n in ns])) * 8


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def test_fft2_matches_numpy(rng):
    x = (rng.random((4, 128, 256)) + 1j * rng.random((4, 128, 256))
         - 0.5 - 0.5j).astype(np.complex64)
    got = np.asarray(ndim.fft2(jnp.asarray(x)))
    want = np.fft.fft2(x.astype(np.complex128))
    assert np.max(np.abs(got - want)) < _tol(128, 256) * np.sqrt(128 * 256)


def test_ifft2_roundtrip(rng):
    x = (rng.random((2, 64, 128)) + 1j * rng.random((2, 64, 128))
         - 0.5 - 0.5j).astype(np.complex64)
    y = ndim.ifft2(ndim.fft2(jnp.asarray(x)))
    assert np.max(np.abs(np.asarray(y) - x)) < 1e-4


def test_fftn_axes_subset(rng):
    x = (rng.random((3, 64, 32)) + 1j * rng.random((3, 64, 32))
         - 0.5 - 0.5j).astype(np.complex64)
    got = np.asarray(ndim.fftn(jnp.asarray(x), axes=(1,)))
    want = np.fft.fft(x.astype(np.complex128), axis=1)
    assert np.max(np.abs(got - want)) < _tol(64) * 8


def test_fftn_middle_axis_and_order(rng):
    # transform over a non-contiguous axis pair; compare to numpy fftn
    x = (rng.random((32, 4, 64)) + 1j * rng.random((32, 4, 64))
         - 0.5 - 0.5j).astype(np.complex64)
    got = np.asarray(ndim.fftn(jnp.asarray(x), axes=(0, 2)))
    want = np.fft.fftn(x.astype(np.complex128), axes=(0, 2))
    assert np.max(np.abs(got - want)) < _tol(32, 64) * np.sqrt(32 * 64)


def test_rfft2_matches_numpy(rng):
    x = (rng.random((64, 256)) - 0.5).astype(np.float32)
    got = np.asarray(ndim.rfft2(jnp.asarray(x)))
    want = np.fft.rfft2(x.astype(np.float64))
    assert got.shape == want.shape == (64, 129)
    assert np.max(np.abs(got - want)) < _tol(64, 256) * np.sqrt(64 * 256)


def test_irfft2_roundtrip(rng):
    x = (rng.random((32, 128)) - 0.5).astype(np.float32)
    y = ndim.irfft2(ndim.rfft2(jnp.asarray(x)), n=128)
    assert np.max(np.abs(np.asarray(y) - x)) < 1e-4


def test_unsupported_axis_length_raises(rng):
    x = jnp.zeros((5, 64), jnp.complex64)   # 5 is not a supported size
    with pytest.raises(ValueError, match="wrong FFT length"):
        ndim.fft2(x)


def test_repeated_axes_raise():
    x = jnp.zeros((32, 32), jnp.complex64)
    with pytest.raises(ValueError, match="repeated axis"):
        ndim.fftn(x, axes=(0, 0))


def test_unordered_multi_axis_raises():
    x = jnp.zeros((32, 32), jnp.complex64)
    with pytest.raises(ValueError, match="single transform axis"):
        ndim.fftn(x, ordered=False)


def test_shift_and_freq_helpers():
    x = jnp.arange(8.0)
    assert np.array_equal(np.asarray(ndim.fftshift(x)),
                          np.fft.fftshift(np.arange(8.0)))
    assert np.array_equal(np.asarray(ndim.ifftshift(ndim.fftshift(x))),
                          np.arange(8.0))
    assert np.allclose(np.asarray(ndim.fftfreq(64, 0.5)),
                       np.fft.fftfreq(64, 0.5))
    assert np.allclose(np.asarray(ndim.rfftfreq(64, 2.0)),
                       np.fft.rfftfreq(64, 2.0))


# ---------------------------------------------------------------------------
# rfftn / irfftn / hfft / ihfft
# ---------------------------------------------------------------------------

def test_rfftn_matches_numpy(rng):
    x = (rng.random((32, 64, 128)) - 0.5).astype(np.float32)
    got = np.asarray(ndim.rfftn(jnp.asarray(x), backend="xla"))
    want = np.fft.rfftn(x.astype(np.float64))
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < 1e-2


def test_irfftn_roundtrip(rng):
    x = (rng.random((2, 64, 128)) - 0.5).astype(np.float32)
    spec = ndim.rfftn(jnp.asarray(x), axes=(-2, -1), backend="xla")
    back = np.asarray(ndim.irfftn(spec, axes=(-2, -1), backend="xla"))
    assert np.max(np.abs(back - x)) < 1e-4


def test_hfft_matches_numpy(rng):
    n = 256
    spec = (rng.random((3, n // 2 + 1)) - 0.5
            + 1j * (rng.random((3, n // 2 + 1)) - 0.5)).astype(np.complex64)
    got = np.asarray(ndim.hfft(jnp.asarray(spec), backend="xla"))
    want = np.fft.hfft(spec.astype(np.complex128))
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < 1e-3


def test_ihfft_matches_numpy(rng):
    n = 256
    x = (rng.random((3, n)) - 0.5).astype(np.float32)
    got = np.asarray(ndim.ihfft(jnp.asarray(x), backend="xla"))
    want = np.fft.ihfft(x.astype(np.float64))
    assert np.max(np.abs(got - want)) < 1e-5


def test_hfft_ihfft_roundtrip(rng):
    n = 512
    x = (rng.random((2, n)) - 0.5).astype(np.float32)
    back = np.asarray(ndim.hfft(ndim.ihfft(jnp.asarray(x), backend="xla"),
                             backend="xla"))
    assert np.max(np.abs(back - x)) < 1e-4


def test_hfft_norm_and_n_match_numpy(rng):
    x = (rng.standard_normal((3, 513)) + 1j * rng.standard_normal((3, 513))
         ).astype(np.complex64)
    for n, norm in [(1024, "ortho"), (1024, "forward"), (2048, None),
                    (512, "backward")]:
        got = np.asarray(ndim.hfft(jnp.asarray(x), n=n, norm=norm,
                                   backend="xla"))
        want = np.fft.hfft(x.astype(np.complex128), n=n, norm=norm)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-3 * np.sqrt(n))


def test_ihfft_norm_and_n_match_numpy(rng):
    x = rng.standard_normal((3, 1000)).astype(np.float32)
    for n, norm in [(1024, "ortho"), (1024, "forward"), (512, None)]:
        got = np.asarray(ndim.ihfft(jnp.asarray(x), n=n, norm=norm,
                                    backend="xla"))
        want = np.fft.ihfft(x.astype(np.float64), n=n, norm=norm)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_hfft_rejects_bad_norm(rng):
    x = jnp.zeros((2, 513), jnp.complex64)
    with pytest.raises(ValueError, match="norm"):
        ndim.hfft(x, norm="bogus", backend="xla")


def test_rfftn_error_names_rfftn():
    x = jnp.zeros((8, 1024), jnp.float32)
    with pytest.raises(ValueError, match="rfftn"):
        ndim.rfftn(x, axes=(1, 0))
    with pytest.raises(ValueError, match="irfftn"):
        ndim.irfftn(jnp.zeros((8, 513), jnp.complex64), axes=(1, 0))
