"""Precision tiers (api.PRECISIONS) on every engine.

"high" is a CONTRACT: max abs error <= 1e-4 vs float64 numpy — the
reference's verification tolerance (SMFFT_CooleyTukey_C2C/FFT.c:12) — at
every supported size.  "exact" is accepted by every backend; on the
matmul engine it runs the same fp32 products as "highest".  Their errors
on the GPU are measured by chip_smoke.py.
"""

import warnings

import numpy as np
import jax.numpy as jnp
import pytest

import smfft as S
from smfft import api
import smfft.params as P
from smfft.ops import matmul_fft

from conftest import max_abs_err


@pytest.mark.parametrize("n", P.SUPPORTED_C2C_SIZES)
def test_high_meets_gate_c2c(rng, n):
    """max abs err <= 1e-4 at every size on the matmul engine."""
    x = (rng.random((4, n)) + 1j * rng.random((4, n))
         - 0.5 - 0.5j).astype(np.complex64)
    got = S.fft(jnp.array(x), backend="xla", precision="high")
    err = max_abs_err(got, np.fft.fft(x.astype(np.complex128)))
    assert err < 1e-4, f"high tier over the 1e-4 gate at n={n}: {err:.2e}"


@pytest.mark.parametrize("n", P.SUPPORTED_REAL_SIZES)
def test_high_meets_gate_r2c(rng, n):
    x = (rng.random((4, n)) - 0.5).astype(np.float32)
    got = S.rfft(jnp.array(x), backend="xla", precision="high")
    err = max_abs_err(got, np.fft.rfft(x.astype(np.float64)))
    assert err < 1e-4, f"high r2c over gate at n={n}: {err:.2e}"


def test_tier_table_covers_every_tier():
    assert set(api.PRECISIONS) == {"exact", "highest", "high", "fast",
                                   "default"}
    assert set(matmul_fft.PRECISIONS) == set(api.PRECISIONS)


def test_exact_is_highest_on_matmul_engine(rng):
    n = 1024
    x = jnp.array((rng.random((8, n)) + 1j * rng.random((8, n))
                   - 0.5 - 0.5j).astype(np.complex64))
    a = np.asarray(S.fft(x, backend="xla", precision="highest"))
    b = np.asarray(S.fft(x, backend="xla", precision="exact"))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend", ["auto", "jnp", "xla", "spec"])
def test_exact_through_api(rng, backend):
    """precision='exact' flows through the public fft/rfft surface on
    every backend."""
    n = 1024
    x = (rng.random(n) + 1j * rng.random(n) - 0.5 - 0.5j
         ).astype(np.complex64)
    got = np.asarray(S.fft(jnp.array(x), backend=backend,
                           precision="exact"))
    ref = np.fft.fft(x.astype(np.complex128))
    assert np.max(np.abs(got - ref)) <= 2e-5
    xr = rng.standard_normal(2048).astype(np.float32)
    gr = np.asarray(S.rfft(jnp.array(xr), backend=backend,
                           precision="exact"))
    rr = np.fft.rfft(xr.astype(np.float64))
    assert np.max(np.abs(gr - rr)) <= 5e-5


@pytest.mark.parametrize("tier", ["fast", "default"])
def test_low_tiers_run(rng, tier):
    n = 512
    x = (rng.random((4, n)) + 1j * rng.random((4, n))
         - 0.5 - 0.5j).astype(np.complex64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        got = np.asarray(S.fft(jnp.array(x), backend="xla", precision=tier))
    assert got.shape == x.shape and np.all(np.isfinite(got))


def test_default_tier_warns(monkeypatch):
    monkeypatch.setattr(api, "_warned_precisions", set())
    with pytest.warns(UserWarning, match="default"):
        S.fft(jnp.zeros((2, 64), jnp.complex64), backend="xla",
              precision="default")
