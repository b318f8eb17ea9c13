"""Semantic-spec tests: the three model families vs numpy.fft.

Mirrors the reference's golden-reference integration-test strategy
(cuFFT oracle, SMFFT_CooleyTukey_C2C/FFT.c:52-77) with numpy.fft as oracle
and deterministic seeded inputs (the reference seeds with time(NULL),
FFT.c:139 — non-reproducible by design; we fix that, SURVEY.md §4).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from smfft.models.cooley_tukey import fft_dit, bit_reverse_indices
from smfft.models.stockham import fft_stockham
from smfft.models import real as R
from smfft.params import SUPPORTED_C2C_SIZES, SUPPORTED_REAL_SIZES

from conftest import max_abs_err


def rand_c(rng, b, n):
    return (rng.random((b, n)) + 1j * rng.random((b, n))
            - 0.5 - 0.5j).astype(np.complex64)


# fp32 error floor grows ~ sqrt(N); 1e-4 matches the reference tolerance
# (FFT.c:12), and we assert a much tighter size-scaled bound.
def tol(n):
    return 2e-7 * n ** 0.75 * 8


@pytest.mark.parametrize("n", SUPPORTED_C2C_SIZES)
def test_dit_forward(rng, n):
    x = rand_c(rng, 4, n)
    assert max_abs_err(fft_dit(jnp.array(x)),
                       np.fft.fft(x.astype(np.complex128))) < tol(n)


@pytest.mark.parametrize("n", SUPPORTED_C2C_SIZES)
def test_dit_inverse_unnormalized(rng, n):
    x = rand_c(rng, 4, n)
    ref = np.fft.ifft(x.astype(np.complex128)) * n
    assert max_abs_err(fft_dit(jnp.array(x), inverse=True), ref) < tol(n)


@pytest.mark.parametrize("n", [32, 256, 2048])
def test_dit_noreorder_is_bitreversed(rng, n):
    """The fft_reorder=0 contract: out[i] == X[bitrev(i)] — verified, unlike
    the reference which skips verification for noreorder (FFT.c:161-163)."""
    x = rand_c(rng, 4, n)
    ref = np.fft.fft(x.astype(np.complex128))
    u = np.asarray(fft_dit(jnp.array(x), ordered=False))
    assert max_abs_err(u[:, bit_reverse_indices(n)], ref) < tol(n)


@pytest.mark.parametrize("n", SUPPORTED_C2C_SIZES)
def test_stockham_ordered(rng, n):
    x = rand_c(rng, 4, n)
    assert max_abs_err(fft_stockham(jnp.array(x)),
                       np.fft.fft(x.astype(np.complex128))) < tol(n)


def test_stockham_inverse_convention_quirk(rng):
    """The standalone Stockham C2C variant computes the positive-exponent DFT
    (validated against CUFFT_INVERSE in the reference,
    SMFFT_Stockham_C2C/FFT-GPU-32bit-Stockham.cu:76,429)."""
    x = rand_c(rng, 4, 256)
    ref = np.fft.ifft(x.astype(np.complex128)) * 256
    assert max_abs_err(fft_stockham(jnp.array(x), inverse=True), ref) < tol(256)


@pytest.mark.parametrize("n", SUPPORTED_REAL_SIZES)
def test_rfft_spec_numpy_layout(rng, n):
    x = (rng.random((4, n)) - 0.5).astype(np.float32)
    assert max_abs_err(R.rfft_spec(jnp.array(x)),
                       np.fft.rfft(x.astype(np.float64))) < tol(n)


@pytest.mark.parametrize("n", [64, 512, 4096])
def test_rfft_packed_layout(rng, n):
    """Packed layout: slot 0 = (DC, Nyquist), matching the reference's
    compare logic (SMFFT_Stockham_R2C_C2R/FFT.c:136-143)."""
    x = (rng.random((4, n)) - 0.5).astype(np.float32)
    ref = np.fft.rfft(x.astype(np.float64))
    got = np.asarray(R.rfft_spec(jnp.array(x), packed=True))
    assert max_abs_err(got[..., 0].real, ref[..., 0].real) < tol(n)
    assert max_abs_err(got[..., 0].imag, ref[..., n // 2].real) < tol(n)
    assert max_abs_err(got[..., 1:], ref[..., 1:n // 2]) < tol(n)


@pytest.mark.parametrize("n", [64, 512, 4096])
@pytest.mark.parametrize("packed", [False, True])
def test_c2r_roundtrip(rng, n, packed):
    """The reference's disabled TEST_C2R round-trip self-test, promoted to a
    real test (SMFFT_Stockham_R2C_C2R/FFT-GPU-32bit-Stockham.cu:595-623):
    C2R(R2C(x)) == (N/2) * x before normalization."""
    x = (rng.random((4, n)) - 0.5).astype(np.float32)
    spec = R.rfft_spec(jnp.array(x), packed=packed)
    back = R.irfft_spec(spec, n, packed=packed, normalize=True)
    assert max_abs_err(back, x) < tol(n)


def test_layout_conversions_roundtrip(rng):
    x = (rng.random((4, 512)) - 0.5).astype(np.float32)
    spec = R.rfft_spec(jnp.array(x))
    p = R.numpy_to_packed_layout(spec)
    back = R.packed_to_numpy_layout(p)
    assert max_abs_err(back, spec) == 0.0
