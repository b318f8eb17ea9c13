"""Public planar API (smfft.planar) vs the numpy.fft oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

import smfft.params as P
from smfft import planar
from smfft.ops.matmul_fft import digit_reverse_indices


@pytest.fixture
def rng():
    return np.random.default_rng(9)


def c_of(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def rand_c(rng, *shape):
    return (rng.random(shape) + 1j * rng.random(shape)
            - 0.5 - 0.5j).astype(np.complex64)


def planar_of(x):
    return jnp.asarray(x.real), jnp.asarray(x.imag)


def bound(n):
    return 2e-7 * n ** 0.75 * 8


def test_fft_ifft_roundtrip_3d_batch(rng):
    x = rand_c(rng, 2, 3, 512)
    fr, fi = planar.fft(*planar_of(x))
    got = c_of((fr, fi))
    want = np.fft.fft(x.astype(np.complex128))
    assert got.shape == x.shape
    assert np.max(np.abs(got - want)) < 1e-3
    br, bi = planar.ifft(fr, fi)
    assert np.max(np.abs(c_of((br, bi)) - x)) < 1e-4


def test_ifft_norm_none_unnormalized(rng):
    x = rand_c(rng, 4, 256)
    fr, fi = planar.fft(*planar_of(x))
    br, bi = planar.ifft(fr, fi, norm=None)
    assert np.max(np.abs(c_of((br, bi)) - 256 * x)) < 1e-2


def test_unordered_roundtrip(rng):
    x = rand_c(rng, 8, 1024)
    fr, fi = planar.fft(*planar_of(x), ordered=False)
    br, bi = planar.ifft_unordered(fr, fi)
    assert np.max(np.abs(c_of((br, bi)) - x)) < 1e-4


def test_rfft_irfft_packed_roundtrip(rng):
    x = (rng.random((5, 512)) - 0.5).astype(np.float32)
    hr, hi = planar.rfft(jnp.asarray(x))
    assert hr.shape == (5, 256)
    # packed natural layout: slot 0 = (DC, Nyquist)
    spec = np.fft.rfft(x.astype(np.float64))
    got = c_of((hr, hi))
    assert np.max(np.abs(got[:, 1:] - spec[:, 1:256])) < 1e-3
    assert np.max(np.abs(np.asarray(hr)[:, 0] - spec[:, 0].real)) < 1e-3
    assert np.max(np.abs(np.asarray(hi)[:, 0] - spec[:, 256].real)) < 1e-3
    y = planar.irfft(hr, hi)
    assert np.max(np.abs(np.asarray(y) - x)) < 1e-4


def test_convolve_matches_oracle(rng):
    n = 256
    x = rand_c(rng, 6, n)
    h = rand_c(rng, n)
    o_r, o_i = planar.convolve(*planar_of(x), *planar_of(h))
    want = np.fft.ifft(np.fft.fft(x.astype(np.complex128))
                       * h.astype(np.complex128))
    assert np.max(np.abs(c_of((o_r, o_i)) - want)) < 1e-4


def test_fft_any_planar(rng):
    n = 300
    np_pad = 384
    x = rand_c(rng, 4, n)
    vr = np.zeros((4, np_pad), np.float32)
    vi = np.zeros((4, np_pad), np.float32)
    vr[:, :n], vi[:, :n] = x.real, x.imag
    o_r, o_i = planar.fft_any(jnp.asarray(vr), jnp.asarray(vi), n=n)
    got = c_of((o_r, o_i))
    want = np.fft.fft(x.astype(np.complex128))
    assert np.max(np.abs(got[:, :n] - want)) < 1e-3
    assert np.max(np.abs(got[:, n:])) == 0.0


def test_fft_any_rejects_unpadded_rows():
    with pytest.raises(ValueError, match="padded row width"):
        planar.fft_any(jnp.zeros((2, 300)), jnp.zeros((2, 300)))


def test_shape_mismatch_raises():
    with pytest.raises(ValueError, match="planar pair"):
        planar.fft(jnp.zeros((2, 256)), jnp.zeros((3, 256)))


def test_wrong_length_raises():
    with pytest.raises(ValueError, match="wrong FFT length"):
        planar.fft(jnp.zeros((2, 100)), jnp.zeros((2, 100)))
    with pytest.raises(ValueError, match="wrong FFT length"):
        planar.rfft(jnp.zeros((2, 128)))


# ---------------------------------------------------------------------------
# every layout at every supported size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", P.SUPPORTED_C2C_SIZES)
def test_ordered_layout_every_size(rng, n):
    x = rand_c(rng, 2, n)
    got = c_of(planar.fft(*planar_of(x)))
    assert np.max(np.abs(got - np.fft.fft(x.astype(np.complex128)))) \
        < bound(n)
    back = c_of(planar.ifft(*planar_of(got.astype(np.complex64))))
    assert np.max(np.abs(back - x)) < 1e-5


@pytest.mark.parametrize("n", P.SUPPORTED_C2C_SIZES)
def test_unordered_layout_every_size(rng, n):
    """ordered=False is the matmul engine's digit-reversed order:
    natural[k] = unordered[perm[k]]."""
    x = rand_c(rng, 2, n)
    fr, fi = planar.fft(*planar_of(x), ordered=False)
    perm = digit_reverse_indices(n, P.get_factorization(n))
    natural = c_of((fr, fi))[:, perm]
    assert np.max(np.abs(natural - np.fft.fft(x.astype(np.complex128)))) \
        < bound(n)
    back = c_of(planar.ifft_unordered(fr, fi))
    assert np.max(np.abs(back - x)) < 1e-5


@pytest.mark.parametrize("n", [s for s in P.SUPPORTED_REAL_SIZES
                               if s >= 256])
def test_packed_real_layout_every_size(rng, n):
    x = (rng.random((2, n)) - 0.5).astype(np.float32)
    hr, hi = planar.rfft(jnp.asarray(x))
    spec = np.fft.rfft(x.astype(np.float64))
    got = c_of((hr, hi))
    assert np.max(np.abs(got[:, 1:] - spec[:, 1:n // 2])) < bound(n)
    assert np.max(np.abs(got[:, 0].real - spec[:, 0].real)) < bound(n)
    assert np.max(np.abs(got[:, 0].imag - spec[:, n // 2].real)) < bound(n)
    raw = planar.irfft(hr, hi, norm=None)
    assert np.max(np.abs(np.asarray(raw) / (n // 2) - x)) < 1e-5


@pytest.mark.parametrize("n", [s for s in P.SUPPORTED_REAL_SIZES
                               if s >= 256])
def test_unordered_real_layout_every_size(rng, n):
    """rfft(ordered=False) holds the packed bins in the digit-reversed
    order of the N/2 factorization; irfft(in_natural=False) inverts it."""
    x = (rng.random((2, n)) - 0.5).astype(np.float32)
    ur, ui = planar.rfft(jnp.asarray(x), ordered=False)
    nr, ni = planar.rfft(jnp.asarray(x))
    perm = digit_reverse_indices(n // 2, P.get_factorization(n // 2))
    np.testing.assert_array_equal(c_of((ur, ui))[:, perm], c_of((nr, ni)))
    y = planar.irfft(ur, ui, in_natural=False)
    assert np.max(np.abs(np.asarray(y) - x)) < 1e-5
