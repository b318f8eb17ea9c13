"""Tests that need an NVIDIA GPU: the auto route and both engines on the
card.  They skip elsewhere; chip_smoke.py runs them on the card."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import smfft as S
from smfft import api

from conftest import max_abs_err

pytestmark = pytest.mark.gpu


def bound(n):
    return 2e-7 * n ** 0.75 * 8


def rand_c(rng, *shape):
    return (rng.uniform(-1, 1, shape)
            + 1j * rng.uniform(-1, 1, shape)).astype(np.complex64)


def test_auto_takes_jnp_route_on_gpu(gpu_device):
    assert api._resolve_backend("auto") == "jnp"
    assert api._resolve_backend("auto", ordered=False) == "xla"
    assert api._resolve_backend("auto", huge_elems=1 << 15) == "xla"


@pytest.mark.parametrize("backend", ["auto", "xla"])
@pytest.mark.parametrize("n", [32, 4096, 16384])
def test_c2c_on_gpu(gpu_device, rng, backend, n):
    """On the card the matmul engine at "highest" keeps fp32 products
    (TF32 would miss the bound at large N)."""
    x = rand_c(rng, 64, n)
    got = S.fft(jax.device_put(x, gpu_device), backend=backend)
    assert max_abs_err(got, np.fft.fft(x.astype(np.complex128))) < bound(n)
    back = S.ifft(got, backend=backend)
    assert max_abs_err(back, x) < 1e-5


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_real_on_gpu(gpu_device, rng, backend):
    n = 2048
    x = rng.uniform(-1, 1, (64, n)).astype(np.float32)
    spec = S.rfft(jax.device_put(x, gpu_device), backend=backend)
    assert max_abs_err(spec, np.fft.rfft(x.astype(np.float64))) < bound(n)
    assert max_abs_err(S.irfft(spec, backend=backend), x) < 1e-5


def test_unordered_pair_on_gpu(gpu_device, rng):
    x = jax.device_put(rand_c(rng, 64, 1024), gpu_device)
    back = S.ifft_unordered(S.fft(x, ordered=False))
    assert max_abs_err(back, np.asarray(x)) < 1e-5


def test_convolve_real_bank_on_gpu(gpu_device, rng):
    n, m = 4096, 4
    x = rng.uniform(-1, 1, (32, n)).astype(np.float32)
    h = np.fft.rfft(rng.uniform(-1, 1, (m, n))).astype(np.complex64)
    got = S.convolve_real(jax.device_put(x, gpu_device), jnp.asarray(h))
    want = np.fft.irfft(np.fft.rfft(x.astype(np.float64))[None]
                        * h.astype(np.complex128)[:, None], n)
    assert got.shape == (m, 32, n)
    assert max_abs_err(got, want) < bound(n)


def test_fft_large_on_gpu(gpu_device, rng):
    n = 1 << 20
    x = rand_c(rng, 1, n)
    got = S.fft_large(jax.device_put(x, gpu_device))
    assert max_abs_err(got, np.fft.fft(x.astype(np.complex128))) < bound(n)


def test_grad_under_jit_on_gpu(gpu_device, rng):
    x = jax.device_put(rng.uniform(-1, 1, (8, 1024)).astype(np.float32),
                       gpu_device)
    g = jax.jit(jax.grad(lambda v: jnp.sum(jnp.abs(S.rfft(v)) ** 2)))(x)
    want = jax.grad(lambda v: jnp.sum(jnp.abs(jnp.fft.rfft(v)) ** 2))(x)
    assert max_abs_err(g, want) < 1e-2
