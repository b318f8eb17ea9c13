"""Public-API dispatch tests across backends (xla / spec / jnp), and the
``auto`` rule."""

import jax
import numpy as np
import jax.numpy as jnp
import pytest

import smfft as S
from smfft import api
import smfft.params as P

from conftest import max_abs_err


@pytest.fixture(params=["xla", "spec", "jnp"])
def backend(request):
    return request.param


def rand_c(rng, b, n):
    return (rng.random((b, n)) + 1j * rng.random((b, n))
            - 0.5 - 0.5j).astype(np.complex64)


def test_fft_all_backends(rng, backend):
    x = rand_c(rng, 64, 256)
    got = S.fft(jnp.array(x), backend=backend)
    assert max_abs_err(got, np.fft.fft(x.astype(np.complex128))) < 1e-4


def test_ifft_norm_backward(rng, backend):
    x = rand_c(rng, 64, 256)
    got = S.ifft(jnp.array(x), backend=backend)
    assert max_abs_err(got, np.fft.ifft(x.astype(np.complex128))) < 1e-6


def test_ifft_norm_none_matches_reference_contract(rng):
    """norm=None returns the raw unnormalized inverse (SURVEY.md quirk 3)."""
    x = rand_c(rng, 16, 512)
    got = S.ifft(jnp.array(x), backend="xla", norm=None)
    ref = np.fft.ifft(x.astype(np.complex128)) * 512
    assert max_abs_err(got, ref) < 1e-3


def test_rfft_irfft_all_backends(rng, backend):
    x = (rng.random((64, 512)) - 0.5).astype(np.float32)
    spec = S.rfft(jnp.array(x), backend=backend)
    assert max_abs_err(spec, np.fft.rfft(x.astype(np.float64))) < 1e-4
    back = S.irfft(spec, backend=backend)
    assert max_abs_err(back, x) < 1e-5


def test_fft_packed_real(rng, backend):
    x = (rng.random((64, 512)) - 0.5).astype(np.float32)
    got = np.asarray(S.fft_packed_real(jnp.array(x), backend=backend))
    ref = np.fft.rfft(x.astype(np.float64))
    assert got.shape == (64, 256)
    assert max_abs_err(got[:, 0].real, ref[:, 0].real) < 1e-4
    assert max_abs_err(got[:, 0].imag, ref[:, 256].real) < 1e-4
    assert max_abs_err(got[:, 1:], ref[:, 1:256]) < 1e-4


def test_unordered_fft_xla(rng):
    from smfft.ops.matmul_fft import digit_reverse_indices
    x = rand_c(rng, 16, 1024)
    u = np.asarray(S.fft(jnp.array(x), ordered=False, backend="xla"))
    perm = digit_reverse_indices(1024, P.get_factorization(1024))
    assert max_abs_err(u[:, perm], np.fft.fft(x.astype(np.complex128))) < 1e-4


def test_plan_system():
    from smfft import plan_for, FFTParams
    p = plan_for(1024)
    assert p.exp == 10 and p.core_n == 1024 and p.sign == -1.0
    q = plan_for(1024, "inverse", "r2c")
    assert q.core_n == 512 and q.sign == +1.0
    assert plan_for(1024) is plan_for(1024)  # cached
    with pytest.raises(ValueError, match="wrong FFT length"):
        FFTParams(n=100)


@pytest.mark.parametrize("unordered_backend", ["xla", "spec", "auto"])
def test_ifft_unordered_roundtrip(rng, unordered_backend):
    """fft(ordered=False) |> ifft_unordered == x on every backend that
    has an unordered layout."""
    x = rand_c(rng, 64, 1024)
    u = S.fft(jnp.array(x), ordered=False, backend=unordered_backend)
    back = api.ifft_unordered(u, backend=unordered_backend)
    assert max_abs_err(back, x) < 1e-5


# ---------------------------------------------------------------------------
# the jnp.fft route at every supported size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", P.SUPPORTED_C2C_SIZES)
def test_jnp_backend_c2c_every_size(rng, n):
    x = rand_c(rng, 3, n)
    got = S.fft(jnp.array(x), backend="jnp")
    ref = np.fft.fft(x.astype(np.complex128))
    assert max_abs_err(got, ref) < 2e-7 * n ** 0.75 * 8
    raw = S.ifft(got, backend="jnp", norm=None)
    assert max_abs_err(raw / n, x) < 1e-5


@pytest.mark.parametrize("n", P.SUPPORTED_REAL_SIZES)
def test_jnp_backend_real_every_size(rng, n):
    """rfft / packed rfft / irfft (both norms, both layouts) on jnp.fft."""
    x = (rng.random((3, n)) - 0.5).astype(np.float32)
    ref = np.fft.rfft(x.astype(np.float64))
    bound = 2e-7 * n ** 0.75 * 8
    spec = S.rfft(jnp.array(x), backend="jnp")
    assert max_abs_err(spec, ref) < bound
    packed = np.asarray(S.fft_packed_real(jnp.array(x), backend="jnp"))
    assert max_abs_err(packed[:, 0].real, ref[:, 0].real) < bound
    assert max_abs_err(packed[:, 0].imag, ref[:, n // 2].real) < bound
    assert max_abs_err(packed[:, 1:], ref[:, 1:n // 2]) < bound
    assert max_abs_err(S.irfft(spec, backend="jnp"), x) < 1e-5
    raw = S.irfft(jnp.asarray(packed), n=n, backend="jnp", norm=None,
                  packed=True)
    assert max_abs_err(np.asarray(raw) / (n // 2), x) < 1e-5


# ---------------------------------------------------------------------------
# the auto rule and the backend / precision vocabulary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("platform,ordered,want", [
    ("gpu", True, "jnp"), ("gpu", False, "xla"),
    ("cpu", True, "xla"), ("cpu", False, "xla")])
def test_auto_rule(monkeypatch, platform, ordered, want):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert api._resolve_backend("auto", ordered) == want


@pytest.mark.parametrize("platform,elems,want", [
    ("gpu", api.HUGE_JNP_MIN_ELEMS - 1, "xla"),
    ("gpu", api.HUGE_JNP_MIN_ELEMS, "jnp"),
    ("gpu", 1 << 27, "jnp"),
    ("cpu", 1 << 27, "xla")])
def test_auto_rule_huge(monkeypatch, platform, elems, want):
    """Huge N: the four-step over matmul rows below the element threshold
    on a GPU, jnp.fft at full length from it up; explicit backends are
    kept whatever the size."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert api._resolve_backend("auto", huge_elems=elems) == want
    assert api._resolve_backend("jnp", huge_elems=1) == "jnp"
    assert api._resolve_backend("xla", huge_elems=1 << 27) == "xla"


def _route_cases():
    """(name, fn(backend) -> result, input kind) for every main-path entry
    point that takes the ordered route."""
    return {
        "fft": lambda x, r, b: S.fft(x, backend=b),
        "ifft": lambda x, r, b: S.ifft(x, backend=b),
        "rfft": lambda x, r, b: S.rfft(r, backend=b),
        "fft_packed_real": lambda x, r, b: S.fft_packed_real(r, backend=b),
        "irfft": lambda x, r, b: S.irfft(S.rfft(r, backend="xla"),
                                         backend=b),
        "convolve": lambda x, r, b: S.convolve(x, x[0], backend=b),
        "convolve_real": lambda x, r, b: S.convolve_real(
            r, S.rfft(r[0], backend="xla"), backend=b),
        # (2, 2**19): at the huge-N element threshold
        "fft_large": lambda x, r, b: S.fft_large(
            jnp.tile(x, (1, 2048)), backend=b),
        "rfft_large": lambda x, r, b: S.rfft_large(
            jnp.tile(r, (1, 2048)), backend=b),
    }


@pytest.mark.parametrize("entry", sorted(_route_cases()))
def test_auto_on_gpu_takes_jnp_route(rng, monkeypatch, entry):
    """With a GPU as the default backend, ``auto`` gives exactly what the
    ``jnp`` backend gives (the route, not just the numbers)."""
    fn = _route_cases()[entry]
    x = jnp.array(rand_c(rng, 2, 256))
    r = jnp.array((rng.random((2, 256)) - 0.5).astype(np.float32))
    want = np.asarray(fn(x, r, "jnp"))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    got = np.asarray(fn(x, r, "auto"))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("entry", ["fft_large", "ifft_large", "rfft_large",
                                   "irfft_large"])
def test_auto_on_gpu_small_huge_takes_four_step(rng, monkeypatch, entry):
    """Below the huge-N element threshold, ``auto`` on a GPU gives exactly
    the four-step over matmul rows (``backend="xla"``)."""
    n = 1 << 15
    x = jnp.array(rand_c(rng, 2, n))
    r = jnp.array((rng.random((2, n)) - 0.5).astype(np.float32))
    fn = {"fft_large": lambda b: S.fft_large(x, backend=b),
          "ifft_large": lambda b: S.ifft_large(x, backend=b),
          "rfft_large": lambda b: S.rfft_large(r, backend=b),
          "irfft_large": lambda b: S.irfft_large(x[:, :n // 2 + 1], n=n,
                                                 backend=b)}[entry]
    want = np.asarray(fn("xla"))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    np.testing.assert_array_equal(np.asarray(fn("auto")), want)


@pytest.mark.parametrize("call", [
    lambda: S.fft(jnp.zeros((2, 64), jnp.complex64), backend="pallas"),
    lambda: S.rfft(jnp.zeros((2, 64)), backend="pallas"),
    lambda: S.convolve(jnp.zeros((2, 64), jnp.complex64),
                       jnp.zeros(64, jnp.complex64), backend="pallas"),
    lambda: api.ifft_unordered(jnp.zeros((2, 64), jnp.complex64),
                               backend="pallas"),
])
def test_removed_pallas_backend_raises(call):
    with pytest.raises(ValueError, match="pallas"):
        call()


def test_jnp_backend_has_no_unordered_layout():
    x = jnp.zeros((2, 64), jnp.complex64)
    with pytest.raises(ValueError, match="natural-order"):
        S.fft(x, ordered=False, backend="jnp")
    with pytest.raises(ValueError, match="natural-order"):
        api.ifft_unordered(x, backend="jnp")


def test_unknown_precision_raises():
    with pytest.raises(ValueError, match="precision"):
        S.fft(jnp.zeros((2, 64), jnp.complex64), precision="bf16")
