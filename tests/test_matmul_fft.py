"""Mixed-radix matmul engine tests: every size, direction, ordering, and
several radix splits, cross-checked against numpy.fft and the specs."""

import numpy as np
import jax.numpy as jnp
import pytest

import smfft.params as P
from smfft.ops.matmul_fft import fft_matmul, digit_reverse_indices

from conftest import max_abs_err


def rand_c(rng, b, n):
    return (rng.random((b, n)) + 1j * rng.random((b, n))
            - 0.5 - 0.5j).astype(np.complex64)


def tol(n):
    return 2e-7 * n ** 0.75 * 8


@pytest.mark.parametrize("n", P.SUPPORTED_C2C_SIZES)
@pytest.mark.parametrize("inverse", [False, True])
def test_ordered_all_sizes(rng, n, inverse):
    x = rand_c(rng, 4, n)
    ref = (np.fft.ifft(x.astype(np.complex128)) * n if inverse
           else np.fft.fft(x.astype(np.complex128)))
    got = fft_matmul(jnp.array(x), inverse=inverse)
    assert max_abs_err(got, ref) < tol(n)


@pytest.mark.parametrize("n", P.SUPPORTED_C2C_SIZES)
def test_unordered_digit_reversed(rng, n):
    x = rand_c(rng, 4, n)
    ref = np.fft.fft(x.astype(np.complex128))
    u = np.asarray(fft_matmul(jnp.array(x), ordered=False))
    perm = digit_reverse_indices(n, P.get_factorization(n))
    assert max_abs_err(u[:, perm], ref) < tol(n)


@pytest.mark.parametrize("radices", [(2,) * 8, (4, 4, 4, 4), (16, 16),
                                     (64, 4), (8, 8, 4), (256,)])
def test_radix_splits_equivalent(rng, radices):
    n = int(np.prod(radices))
    x = rand_c(rng, 4, n)
    ref = np.fft.fft(x.astype(np.complex128))
    got = fft_matmul(jnp.array(x), radices=radices)
    assert max_abs_err(got, ref) < tol(n)


def test_all_radix_2_unordered_is_bitreversed(rng):
    """With all radices 2, digit reversal == bit reversal (CT parity)."""
    from smfft.models.cooley_tukey import bit_reverse_indices
    n = 128
    radices = (2,) * 7
    perm = digit_reverse_indices(n, radices)
    assert np.array_equal(perm, bit_reverse_indices(n))


@pytest.mark.parametrize("precision", ["default", "high", "highest",
                                       "exact"])
def test_precision_modes_run(rng, precision):
    x = rand_c(rng, 4, 256)
    ref = np.fft.fft(x.astype(np.complex128))
    got = fft_matmul(jnp.array(x), precision=precision)
    # On CPU all precisions are exact fp32; on a GPU "default" is TF32.
    assert max_abs_err(got, ref) < 1.0


def test_batch_shapes_preserved(rng):
    x = rand_c(rng, 6, 256).reshape(2, 3, 256)
    got = fft_matmul(jnp.array(x))
    assert got.shape == (2, 3, 256)
    ref = np.fft.fft(x.astype(np.complex128))
    assert max_abs_err(got, ref) < tol(256)


def test_wrong_size_raises():
    import smfft as S
    with pytest.raises(ValueError, match="wrong FFT length"):
        S.fft(jnp.zeros((4, 100), jnp.complex64))
    with pytest.raises(ValueError, match="wrong FFT length"):
        S.fft(jnp.zeros((4, 32768), jnp.complex64))


def test_inverse_roundtrip(rng):
    import smfft as S
    x = rand_c(rng, 4, 1024)
    y = S.fft(jnp.array(x), backend="xla")
    back = S.ifft(y, backend="xla")
    assert max_abs_err(back, x) < 1e-5
