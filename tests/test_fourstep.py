"""Four-step decomposition: local huge-N FFT and the distributed
single-transform path over the 8-device virtual mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import smfft as S
from smfft.ops import fourstep
from smfft.parallel import (batch_mesh, distributed_fft,
                                distributed_ifft, plan_distributed)

from conftest import max_abs_err


def rel_err(got, want):
    want = np.asarray(want, dtype=np.complex128)
    return max_abs_err(got, want) / max(1e-30, float(np.max(np.abs(want))))


def fft_mesh(axis_name="fft"):
    return batch_mesh(axis_name=axis_name)


# ---------------------------------------------------------------------------
# exact modular twiddles
# ---------------------------------------------------------------------------

def test_twiddle_rows_exact_modular(rng):
    """uint32-wraparound exponent reduction matches the fp64 ground truth
    at an N where naive fp32 angles lose ~8 bits."""
    n = 1 << 26
    rows = np.array([0, 1, 12345, (1 << 20) - 1], dtype=np.uint32)
    cols = 512
    b = jnp.ones((len(rows), cols), jnp.complex64)
    got = np.asarray(fourstep.twiddle_rows(b, jnp.array(rows), n, False))
    k = np.arange(cols, dtype=np.float64)
    want = np.exp(-2j * np.pi * (rows[:, None].astype(np.float64) * k) / n)
    assert np.max(np.abs(got - want)) < 1e-6


def test_split_factors():
    assert fourstep.split_factors(1 << 20) == (1024, 1024)
    assert fourstep.split_factors(1 << 21) == (2048, 1024)
    assert fourstep.split_factors(1 << 28) == (16384, 16384)
    with pytest.raises(ValueError, match="wrong FFT length"):
        fourstep.split_factors(3 << 20)   # not a power of two
    with pytest.raises(ValueError, match="wrong FFT length"):
        fourstep.split_factors(1 << 29)   # beyond 16384*16384
    with pytest.raises(ValueError, match="wrong FFT length"):
        fourstep.split_factors(512)       # below 32*32


# ---------------------------------------------------------------------------
# local four-step (fft_large / ifft_large)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1 << 15, 1 << 16, 1 << 17])
def test_fft_large_matches_numpy(rng, n):
    x = (rng.random(n) + 1j * rng.random(n) - 0.5 - 0.5j
         ).astype(np.complex64)
    got = S.fft_large(jnp.array(x), backend="xla")
    assert rel_err(got, np.fft.fft(x.astype(np.complex128))) < 2e-6


def test_fft_large_batched(rng):
    n = 1 << 15
    x = (rng.random((3, n)) + 1j * rng.random((3, n)) - 0.5 - 0.5j
         ).astype(np.complex64)
    got = S.fft_large(jnp.array(x), backend="xla")
    assert rel_err(got, np.fft.fft(x.astype(np.complex128))) < 2e-6


def test_ifft_large_roundtrip(rng):
    n = 1 << 16
    x = (rng.random(n) + 1j * rng.random(n) - 0.5 - 0.5j
         ).astype(np.complex64)
    back = S.ifft_large(S.fft_large(jnp.array(x), backend="xla"),
                        backend="xla")
    assert rel_err(back, x) < 2e-6


def test_ifft_large_norm_none_is_unnormalized(rng):
    n = 1 << 15
    x = (rng.random(n) - 0.5).astype(np.complex64)
    raw = S.ifft_large(jnp.array(x), backend="xla", norm=None)
    div = S.ifft_large(jnp.array(x), backend="xla", norm="backward")
    assert rel_err(raw / n, div) < 1e-6


def test_fft_large_small_sizes_route_to_fft(rng):
    n = 4096
    x = (rng.random(n) + 1j * rng.random(n) - 0.5 - 0.5j
         ).astype(np.complex64)
    got = S.fft_large(jnp.array(x), backend="xla")
    assert rel_err(got, np.fft.fft(x.astype(np.complex128))) < 2e-6


def test_fft_large_rejects_bad_sizes(rng):
    with pytest.raises(ValueError, match="wrong FFT length"):
        S.fft_large(jnp.zeros(3 << 14, jnp.complex64), backend="xla")


@pytest.mark.parametrize("backend", ["jnp", "xla"])
def test_fourstep_explicit_factors(rng, backend):
    """The four-step glue over either engine's row transforms, with the
    factor split given explicitly."""
    n = 1 << 12
    x = (rng.random(n) + 1j * rng.random(n) - 0.5 - 0.5j
         ).astype(np.complex64)
    got = fourstep.fft_four_step(jnp.array(x), backend=backend,
                                 factors=(64, 64))
    assert rel_err(got, np.fft.fft(x.astype(np.complex128))) < 2e-6


@pytest.mark.parametrize("n", [1 << 15, 1 << 16, 1 << 17])
def test_fft_large_jnp_matches_numpy(rng, n):
    """backend='jnp' transforms the full length at once."""
    x = (rng.random((2, n)) + 1j * rng.random((2, n)) - 0.5 - 0.5j
         ).astype(np.complex64)
    got = S.fft_large(jnp.array(x), backend="jnp")
    assert rel_err(got, np.fft.fft(x.astype(np.complex128))) < 2e-6
    back = S.ifft_large(got, backend="jnp")
    assert max_abs_err(back, x) < 1e-5
    raw = S.ifft_large(got, backend="jnp", norm=None)
    assert rel_err(np.asarray(raw) / n, x) < 2e-6


# ---------------------------------------------------------------------------
# huge-N real transforms (rfft_large / irfft_large)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1 << 15, 1 << 17])
def test_rfft_large_matches_numpy(rng, n):
    x = (rng.random(n) - 0.5).astype(np.float32)
    got = S.rfft_large(jnp.array(x), backend="xla")
    assert got.shape == (n // 2 + 1,)
    assert rel_err(got, np.fft.rfft(x.astype(np.float64))) < 2e-6


def test_rfft_large_batched_packed_layout(rng):
    """Packed layout: [0] = DC + 1j*Nyquist, length N/2 (the reference's
    slot-0 contract, FFT-GPU-32bit-Stockham.cu:332-340)."""
    n = 1 << 15
    x = (rng.random((3, n)) - 0.5).astype(np.float32)
    got = np.asarray(S.rfft_large(jnp.array(x), backend="xla",
                                  packed=True))
    want = np.fft.rfft(x.astype(np.float64))
    assert got.shape == (3, n // 2)
    assert np.max(np.abs(got[:, 1:] - want[:, 1:n // 2])) < 1e-2
    assert np.max(np.abs(got[:, 0].real - want[:, 0].real)) < 1e-2
    assert np.max(np.abs(got[:, 0].imag - want[:, n // 2].real)) < 1e-2


@pytest.mark.parametrize("packed", [False, True])
def test_irfft_large_roundtrip(rng, packed):
    n = 1 << 16
    x = (rng.random(n) - 0.5).astype(np.float32)
    spec = S.rfft_large(jnp.array(x), backend="xla", packed=packed)
    back = S.irfft_large(spec, n=n, backend="xla", packed=packed)
    assert np.max(np.abs(np.asarray(back) - x)) < 2e-4


def test_irfft_large_norm_none_is_half_n_scaled(rng):
    """norm=None keeps the reference's raw (N/2)-scaled output
    (SMFFT_Stockham_R2C_C2R/FFT.c:170-171)."""
    n = 1 << 15
    x = (rng.random(n) - 0.5).astype(np.float32)
    spec = S.rfft_large(jnp.array(x), backend="xla")
    raw = S.irfft_large(spec, n=n, backend="xla", norm=None)
    assert np.max(np.abs(np.asarray(raw) / (n // 2) - x)) < 2e-4


def test_rfft_large_small_sizes_route_to_rfft(rng):
    n = 4096
    x = (rng.random(n) - 0.5).astype(np.float32)
    got = S.rfft_large(jnp.array(x), backend="xla")
    assert rel_err(got, np.fft.rfft(x.astype(np.float64))) < 2e-6


def test_rfft_large_rejects_bad_sizes():
    with pytest.raises(ValueError, match="wrong FFT length"):
        S.rfft_large(jnp.zeros(3 << 14, jnp.float32), backend="xla")


def test_half_root_planar_exact():
    """Split-table W_N^k matches the fp64 ground truth at a size where a
    naive fp32 angle would lose precision."""
    n = 1 << 22
    wr, wi = fourstep._half_root_planar(n, False)
    k = np.arange(0, n // 2, 4097, dtype=np.int64)
    want = np.exp(-2j * np.pi * k.astype(np.float64) / n)
    got = np.asarray(wr)[k] + 1j * np.asarray(wi)[k]
    assert np.max(np.abs(got - want)) < 1e-6


# ---------------------------------------------------------------------------
# distributed (8-device mesh, all_to_all)
# ---------------------------------------------------------------------------

def test_plan_distributed():
    assert plan_distributed(1 << 20, 8) == (1024, 1024)
    with pytest.raises(ValueError, match="wrong FFT length"):
        plan_distributed(1024, 64)   # 32 not divisible by 64


@pytest.mark.parametrize("n", [1 << 10, 1 << 17, 1 << 20])
def test_distributed_fft_matches_numpy(rng, n):
    mesh = fft_mesh()
    x = (rng.random(n) + 1j * rng.random(n) - 0.5 - 0.5j
         ).astype(np.complex64)
    got = distributed_fft(jnp.array(x), mesh, backend="xla")
    assert len(got.sharding.device_set) == 8
    assert rel_err(got, np.fft.fft(x.astype(np.complex128))) < 2e-6


def test_distributed_roundtrip(rng):
    mesh = fft_mesh()
    n = 1 << 18
    x = (rng.random(n) + 1j * rng.random(n) - 0.5 - 0.5j
         ).astype(np.complex64)
    back = distributed_ifft(distributed_fft(jnp.array(x), mesh,
                                            backend="xla"),
                            mesh, backend="xla")
    assert rel_err(back, x) < 2e-6


def test_distributed_transposed_contract(rng):
    """C[k1, k2] = X[k2*N1 + k1], k1 sharded over the mesh."""
    mesh = fft_mesh()
    n = 1 << 16
    n1, n2 = plan_distributed(n, 8)
    x = (rng.random(n) + 1j * rng.random(n) - 0.5 - 0.5j
         ).astype(np.complex64)
    c = distributed_fft(jnp.array(x), mesh, backend="xla",
                        transposed_output=True)
    assert c.shape == (n1, n2)
    want = np.fft.fft(x.astype(np.complex128)).reshape(n2, n1).T
    assert rel_err(c, want) < 2e-6


def test_distributed_transposed_roundtrip(rng):
    """forward(transposed_output) |> inverse(transposed_input) -> natural
    x, with the middle matrix never relaid out."""
    mesh = fft_mesh()
    n = 1 << 18
    x = (rng.random(n) + 1j * rng.random(n) - 0.5 - 0.5j
         ).astype(np.complex64)
    c = distributed_fft(jnp.array(x), mesh, backend="xla",
                        transposed_output=True)
    back = distributed_ifft(c, mesh, backend="xla", transposed_input=True)
    assert back.shape == (n,)
    assert rel_err(back, x) < 2e-6


def test_distributed_spectral_filter_in_transposed_layout(rng):
    """The intended round-trip use: pointwise spectral multiply applied
    directly in the C-layout between the two transforms."""
    mesh = fft_mesh()
    n = 1 << 16
    n1, n2 = plan_distributed(n, 8)
    x = (rng.random(n) - 0.5).astype(np.complex64)
    h = (rng.random(n) - 0.5).astype(np.complex64)   # freq response
    c = distributed_fft(jnp.array(x), mesh, backend="xla",
                        transposed_output=True)
    # H in C-layout: H_c[k1, k2] = H[k2*n1 + k1]
    h_c = jnp.array(h.reshape(n2, n1).T)
    y = distributed_ifft(c * h_c, mesh, backend="xla",
                         transposed_input=True)
    want = np.fft.ifft(np.fft.fft(x.astype(np.complex128)) * h)
    assert rel_err(y, want) < 2e-6


def test_distributed_batched(rng):
    """(B, N) batch: every transform matches numpy (r4 VERDICT item 6)."""
    mesh = fft_mesh()
    n = 1 << 16
    x = (rng.standard_normal((3, n))
         + 1j * rng.standard_normal((3, n))).astype(np.complex64)
    got = distributed_fft(jnp.array(x), mesh, backend="xla")
    assert got.shape == (3, n)
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert rel_err(np.asarray(got), want) < 2e-6
    back = distributed_ifft(got, mesh, backend="xla", norm="backward")
    assert max_abs_err(np.asarray(back), x) < 1e-5


def test_distributed_batched_transposed_roundtrip(rng):
    mesh = fft_mesh()
    n = 1 << 16
    x = (rng.standard_normal((2, n))
         + 1j * rng.standard_normal((2, n))).astype(np.complex64)
    c = distributed_fft(jnp.array(x), mesh, backend="xla",
                        transposed_output=True)
    assert c.shape[0] == 2 and c.shape[1] * c.shape[2] == n
    back = distributed_ifft(c, mesh, backend="xla",
                            transposed_input=True, norm="backward")
    assert max_abs_err(np.asarray(back), x) < 1e-5


def test_distributed_rfft_matches_numpy(rng):
    """Distributed pack-trick R2C: packed half-spectrum vs numpy.rfft."""
    from smfft.parallel import distributed_irfft, distributed_rfft
    mesh = fft_mesh()
    n = 1 << 17
    x = rng.standard_normal((2, n)).astype(np.float32)
    h = distributed_rfft(jnp.array(x), mesh, backend="xla")
    assert h.shape == (2, n // 2)
    got = np.asarray(h)
    want = np.fft.rfft(x.astype(np.float64), axis=-1)
    # packed layout: slot 0 = DC + i*Nyq
    full = np.concatenate([got[:, :1].real, got[:, 1:],
                           1j * got[:, :1].imag], axis=-1)
    full[:, 0] = got[:, 0].real
    full[:, -1] = got[:, 0].imag
    scale = np.max(np.abs(want))
    assert np.max(np.abs(full - want)) / scale < 2e-6
    # round trip (normalize=True gives back the signal)
    back = distributed_irfft(h, mesh, backend="xla", normalize=True)
    assert back.shape == (2, n)
    assert np.max(np.abs(np.asarray(back) - x)) < 1e-5


def test_distributed_rfft_vector(rng):
    from smfft.parallel import distributed_irfft, distributed_rfft
    mesh = fft_mesh()
    n = 1 << 16
    x = rng.standard_normal(n).astype(np.float32)
    h = distributed_rfft(jnp.array(x), mesh, backend="xla")
    assert h.shape == (n // 2,)
    back = distributed_irfft(h, mesh, backend="xla")
    assert np.max(np.abs(np.asarray(back) - x)) < 1e-5


def test_distributed_jnp_rows(rng):
    """The jnp.fft row transforms under shard_map + all_to_all."""
    mesh = fft_mesh()
    n = 1 << 11   # 64 x 32
    x = (rng.random(n) + 1j * rng.random(n) - 0.5 - 0.5j
         ).astype(np.complex64)
    got = distributed_fft(jnp.array(x), mesh, backend="jnp")
    assert rel_err(got, np.fft.fft(x.astype(np.complex128))) < 2e-6


def test_large_rejects_bad_norm():
    with pytest.raises(ValueError, match="norm"):
        S.ifft_large(jnp.zeros(1 << 15, jnp.complex64), norm="ortho")
    with pytest.raises(ValueError, match="norm"):
        S.irfft_large(jnp.zeros((1 << 14) + 1, jnp.complex64),
                      norm="ortho")


def test_rfft_large_small_sizes_differentiable(rng):
    import jax
    x = jnp.asarray(rng.standard_normal(1024).astype(np.float32))
    g = jax.grad(lambda v: jnp.sum(jnp.abs(S.rfft_large(v, backend="xla"))
                                   ** 2))(x)
    assert g.shape == x.shape and bool(jnp.all(jnp.isfinite(g)))




@pytest.mark.parametrize("packed", [False, True])
def test_rfft_large_jnp_matches_numpy(rng, packed):
    """backend='jnp': full-length rfft in both layouts, and back."""
    n = 1 << 16
    x = (rng.random((2, n)) - 0.5).astype(np.float32)
    got = np.asarray(S.rfft_large(jnp.array(x), backend="jnp",
                                  packed=packed))
    want = np.fft.rfft(x.astype(np.float64))
    if packed:
        assert got.shape == (2, n // 2)
        assert rel_err(got[:, 1:], want[:, 1:n // 2]) < 2e-6
        assert np.max(np.abs(got[:, 0].real - want[:, 0].real)) < 1e-2
        assert np.max(np.abs(got[:, 0].imag - want[:, n // 2].real)) < 1e-2
    else:
        assert rel_err(got, want) < 2e-6
    back = S.irfft_large(jnp.asarray(got), n=n, backend="jnp",
                         packed=packed)
    assert np.max(np.abs(np.asarray(back) - x)) < 2e-4
    raw = S.irfft_large(jnp.asarray(got), n=n, backend="jnp",
                        packed=packed, norm=None)
    assert np.max(np.abs(np.asarray(raw) / (n // 2) - x)) < 2e-4


def test_planar_fft_large_dispatch(rng):
    """planar.fft_large / ifft_large at 2**15, roundtrip with
    norm='backward'."""
    from smfft import planar
    n = 1 << 15
    xr = (rng.random((2, n)) - 0.5).astype(np.float32)
    xi = (rng.random((2, n)) - 0.5).astype(np.float32)
    o_r, o_i = planar.fft_large(jnp.array(xr), jnp.array(xi))
    want = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
    assert rel_err(np.asarray(o_r) + 1j * np.asarray(o_i), want) < 2e-6
    br, bi = planar.ifft_large(o_r, o_i, norm="backward")
    assert max_abs_err(np.asarray(br) + 1j * np.asarray(bi),
                       xr + 1j * xi) < 1e-5


def test_planar_fft_large_row_sizes_route_to_row_transform(rng):
    from smfft import planar
    n = 1 << 10
    xr = (rng.random((2, n)) - 0.5).astype(np.float32)
    o_r, o_i = planar.fft_large(jnp.array(xr), jnp.zeros((2, n)))
    want = np.fft.fft(xr.astype(np.float64))
    assert rel_err(np.asarray(o_r) + 1j * np.asarray(o_i), want) < 2e-6


def test_planar_rfft_large_roundtrip(rng):
    from smfft import planar
    n = 1 << 15
    x = (rng.random((2, n)) - 0.5).astype(np.float32)
    hr, hi = planar.rfft_large(jnp.array(x))
    want = np.fft.rfft(x.astype(np.float64))
    got = np.asarray(hr) + 1j * np.asarray(hi)
    assert rel_err(got[:, 1:], want[:, 1:n // 2]) < 2e-6
    back = planar.irfft_large(hr, hi)
    assert np.max(np.abs(np.asarray(back) - x)) < 2e-4
    with pytest.raises(ValueError, match="wrong FFT length"):
        planar.rfft_large(jnp.zeros((1, 1 << 14 | 1 << 13)))


@pytest.mark.parametrize("backend", ["jnp", "xla"])
def test_api_fft_large_backends(rng, backend):
    n = 1 << 15
    x = (rng.random(n) + 1j * rng.random(n) - 0.5 - 0.5j
         ).astype(np.complex64)
    got = S.fft_large(jnp.array(x), backend=backend)
    assert rel_err(got, np.fft.fft(x.astype(np.complex128))) < 2e-6
    back = S.ifft_large(got, backend=backend)
    assert max_abs_err(back, x) < 1e-5


@pytest.mark.parametrize("backend", ["jnp", "xla"])
def test_fft_large_differentiable(rng, backend):
    """jax.grad through fft_large: the DFT matrix is symmetric, so the
    gradient matches jnp.fft's."""
    import jax
    n = 1 << 15
    x = (rng.random(n) + 1j * rng.random(n) - 0.5 - 0.5j
         ).astype(np.complex64)
    xj = jnp.array(x)

    g = jax.grad(lambda v: jnp.sum(jnp.abs(S.fft_large(
        v, backend=backend)) ** 2))(xj)
    want = jax.grad(lambda v: jnp.sum(jnp.abs(jnp.fft.fft(v)) ** 2))(xj)
    assert g.shape == xj.shape and bool(jnp.all(jnp.isfinite(g)))
    assert rel_err(np.asarray(g), np.asarray(want)) < 1e-5


@pytest.mark.parametrize("backend", ["jnp", "xla"])
def test_rfft_large_differentiable(rng, backend):
    import jax
    n = 1 << 15
    x = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    g = jax.grad(lambda v: jnp.sum(jnp.abs(S.rfft_large(
        v, backend=backend)) ** 2))(x)
    want = jax.grad(lambda v: jnp.sum(jnp.abs(jnp.fft.rfft(v)) ** 2))(x)
    assert g.shape == x.shape and bool(jnp.all(jnp.isfinite(g)))
    assert rel_err(np.asarray(g), np.asarray(want)) < 1e-5


@pytest.mark.parametrize("backend", ["jnp", "xla"])
def test_irfft_large_differentiable(rng, backend):
    import jax
    n = 1 << 15
    spec = jnp.asarray((rng.standard_normal(n // 2 + 1)
                        + 1j * rng.standard_normal(n // 2 + 1)
                        ).astype(np.complex64))
    g = jax.grad(lambda v: jnp.sum(S.irfft_large(
        v, n=n, backend=backend) ** 2))(spec)
    want = jax.grad(lambda v: jnp.sum(jnp.fft.irfft(v, n=n) ** 2))(spec)
    assert g.shape == spec.shape and bool(jnp.all(jnp.isfinite(g)))
    assert rel_err(np.asarray(g), np.asarray(want)) < 1e-5
