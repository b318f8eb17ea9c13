"""DCT/DST (smfft.dct) vs direct O(n^2) float64 oracles
(scipy.fft definitions, types 2 and 3, norm=None and "ortho")."""

import numpy as np
import pytest

import jax.numpy as jnp

import sys

import smfft.dct  # noqa: F401 — the package re-exports shadow the module
D = sys.modules["smfft.dct"]


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def oracle_dct2(x):
    n = x.shape[-1]
    j = np.arange(n)
    M = 2.0 * np.cos(np.pi * np.outer(np.arange(n), 2 * j + 1) / (2 * n))
    return x.astype(np.float64) @ M.T


def oracle_dct3(x):
    n = x.shape[-1]
    k = np.arange(n)
    M = 2.0 * np.cos(np.pi * np.outer(2 * np.arange(n) + 1, k) / (2 * n))
    M[:, 0] = 1.0
    return x.astype(np.float64) @ M.T


def oracle_dst2(x):
    n = x.shape[-1]
    j = np.arange(n)
    M = 2.0 * np.sin(np.pi * np.outer(np.arange(n) + 1, 2 * j + 1)
                     / (2 * n))
    return x.astype(np.float64) @ M.T


def oracle_dst3(x):
    n = x.shape[-1]
    k = np.arange(n - 1)
    out = np.empty(x.shape, np.float64)
    for jj in range(n):
        out[..., jj] = ((-1.0) ** jj * x[..., n - 1]
                        + 2.0 * np.sum(
            x[..., :n - 1].astype(np.float64)
            * np.sin(np.pi * (k + 1) * (2 * jj + 1) / (2 * n)), axis=-1))
    return out


@pytest.mark.parametrize("n", [64, 256])
def test_dct2_matches_oracle(rng, n):
    x = (rng.random((3, n)) - 0.5).astype(np.float32)
    got = np.asarray(D.dct(jnp.asarray(x), type=2))
    assert np.max(np.abs(got - oracle_dct2(x))) < 1e-3 * np.sqrt(n)


@pytest.mark.parametrize("n", [64, 256])
def test_dct3_matches_oracle(rng, n):
    x = (rng.random((3, n)) - 0.5).astype(np.float32)
    got = np.asarray(D.dct(jnp.asarray(x), type=3))
    assert np.max(np.abs(got - oracle_dct3(x))) < 1e-3 * np.sqrt(n)


@pytest.mark.parametrize("n", [64, 256])
def test_dst2_matches_oracle(rng, n):
    x = (rng.random((3, n)) - 0.5).astype(np.float32)
    got = np.asarray(D.dst(jnp.asarray(x), type=2))
    assert np.max(np.abs(got - oracle_dst2(x))) < 1e-3 * np.sqrt(n)


@pytest.mark.parametrize("n", [64, 256])
def test_dst3_matches_oracle(rng, n):
    x = (rng.random((3, n)) - 0.5).astype(np.float32)
    got = np.asarray(D.dst(jnp.asarray(x), type=3))
    assert np.max(np.abs(got - oracle_dst3(x))) < 1e-3 * np.sqrt(n)


@pytest.mark.parametrize("type", [2, 3])
@pytest.mark.parametrize("norm", [None, "ortho"])
def test_dct_roundtrip(rng, type, norm):
    x = (rng.random((4, 512)) - 0.5).astype(np.float32)
    y = D.idct(D.dct(jnp.asarray(x), type=type, norm=norm),
               type=type, norm=norm)
    assert np.max(np.abs(np.asarray(y) - x)) < 1e-4


@pytest.mark.parametrize("type", [2, 3])
@pytest.mark.parametrize("norm", [None, "ortho"])
def test_dst_roundtrip(rng, type, norm):
    x = (rng.random((4, 512)) - 0.5).astype(np.float32)
    y = D.idst(D.dst(jnp.asarray(x), type=type, norm=norm),
               type=type, norm=norm)
    assert np.max(np.abs(np.asarray(y) - x)) < 1e-4


def test_dct2_ortho_is_orthonormal(rng):
    # rows of the ortho DCT-II matrix are orthonormal: Parseval
    x = (rng.random((8, 256)) - 0.5).astype(np.float32)
    y = np.asarray(D.dct(jnp.asarray(x), type=2, norm="ortho"))
    assert np.allclose(np.sum(y * y, -1), np.sum(x * x, -1), rtol=1e-4)


def test_dst2_ortho_is_orthonormal(rng):
    x = (rng.random((8, 256)) - 0.5).astype(np.float32)
    y = np.asarray(D.dst(jnp.asarray(x), type=2, norm="ortho"))
    assert np.allclose(np.sum(y * y, -1), np.sum(x * x, -1), rtol=1e-4)


def test_bad_type_and_length():
    with pytest.raises(ValueError, match="type"):
        D.dct(jnp.zeros((2, 256)), type=5)
    with pytest.raises(ValueError, match="wrong FFT length"):
        D.dct(jnp.zeros((2, 100)))


# ---------------------------------------------------------------------------
# types 1 and 4
# ---------------------------------------------------------------------------

def oracle_dct1(x):
    n = x.shape[-1]
    k, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    M = 2.0 * np.cos(np.pi * j * k / (n - 1.0))
    M[:, 0] = 1.0
    M[:, n - 1] = (-1.0) ** np.arange(n)
    return x.astype(np.float64) @ M.T


def oracle_dst1(x):
    n = x.shape[-1]
    k, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    M = 2.0 * np.sin(np.pi * (j + 1.0) * (k + 1.0) / (n + 1.0))
    return x.astype(np.float64) @ M.T


def oracle_dct4(x):
    n = x.shape[-1]
    k, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    M = 2.0 * np.cos(np.pi * (2 * j + 1.0) * (2 * k + 1.0) / (4.0 * n))
    return x.astype(np.float64) @ M.T


def oracle_dst4(x):
    n = x.shape[-1]
    k, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    M = 2.0 * np.sin(np.pi * (2 * j + 1.0) * (2 * k + 1.0) / (4.0 * n))
    return x.astype(np.float64) @ M.T


@pytest.mark.parametrize("n", [65, 257])
def test_dct1_matches_oracle(rng, n):
    x = (rng.random((3, n)) - 0.5).astype(np.float32)
    got = np.asarray(D.dct(jnp.asarray(x), type=1))
    assert np.max(np.abs(got - oracle_dct1(x))) < 1e-3 * np.sqrt(n)


@pytest.mark.parametrize("n", [63, 255])
def test_dst1_matches_oracle(rng, n):
    x = (rng.random((3, n)) - 0.5).astype(np.float32)
    got = np.asarray(D.dst(jnp.asarray(x), type=1))
    assert np.max(np.abs(got - oracle_dst1(x))) < 1e-3 * np.sqrt(n)


@pytest.mark.parametrize("n", [64, 256])
def test_dct4_matches_oracle(rng, n):
    x = (rng.random((3, n)) - 0.5).astype(np.float32)
    got = np.asarray(D.dct(jnp.asarray(x), type=4))
    assert np.max(np.abs(got - oracle_dct4(x))) < 1e-3 * np.sqrt(n)


@pytest.mark.parametrize("n", [64, 256])
def test_dst4_matches_oracle(rng, n):
    x = (rng.random((3, n)) - 0.5).astype(np.float32)
    got = np.asarray(D.dst(jnp.asarray(x), type=4))
    assert np.max(np.abs(got - oracle_dst4(x))) < 1e-3 * np.sqrt(n)


@pytest.mark.parametrize("type,n", [(1, 129), (4, 128)])
@pytest.mark.parametrize("norm", [None, "ortho"])
def test_dct14_roundtrip(rng, type, n, norm):
    x = (rng.random((2, n)) - 0.5).astype(np.float32)
    back = np.asarray(D.idct(D.dct(jnp.asarray(x), type=type, norm=norm),
                             type=type, norm=norm))
    assert np.max(np.abs(back - x)) < 2e-4


@pytest.mark.parametrize("type,n", [(1, 127), (4, 128)])
@pytest.mark.parametrize("norm", [None, "ortho"])
def test_dst14_roundtrip(rng, type, n, norm):
    x = (rng.random((2, n)) - 0.5).astype(np.float32)
    back = np.asarray(D.idst(D.dst(jnp.asarray(x), type=type, norm=norm),
                             type=type, norm=norm))
    assert np.max(np.abs(back - x)) < 2e-4


def test_dct14_ortho_is_orthonormal(rng):
    """Parseval: the ortho type-1/4 transforms preserve the 2-norm."""
    for type, nc, ns in ((1, 65, 63), (4, 64, 64)):
        x = (rng.random(nc) - 0.5).astype(np.float32)
        y = np.asarray(D.dct(jnp.asarray(x), type=type, norm="ortho"))
        assert abs(np.sum(y * y) - np.sum(x * x)) < 1e-4 * nc
        xs = (rng.random(ns) - 0.5).astype(np.float32)
        ys = np.asarray(D.dst(jnp.asarray(xs), type=type, norm="ortho"))
        assert abs(np.sum(ys * ys) - np.sum(xs * xs)) < 1e-4 * ns


def test_type1_bad_lengths():
    with pytest.raises(ValueError, match="wrong FFT length"):
        D.dct(jnp.zeros(64, jnp.float32), type=1)    # needs 2^m + 1
    with pytest.raises(ValueError, match="wrong FFT length"):
        D.dst(jnp.zeros(64, jnp.float32), type=1)    # needs 2^m - 1
    with pytest.raises(ValueError, match="wrong FFT length"):
        D.dct(jnp.zeros(16384, jnp.float32), type=4)  # 2N beyond c2c cap


# ---------------------------------------------------------------------------
# N-D (dctn / idctn / dstn / idstn)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", [None, "ortho"])
def test_dctn_separable_matches_axiswise(rng, norm):
    x = (rng.random((64, 128)) - 0.5).astype(np.float32)
    got = np.asarray(D.dctn(jnp.asarray(x), norm=norm))
    step = oracle_dct2(x.astype(np.float64).T).T   # axis 0
    want = oracle_dct2(step)                       # axis 1
    if norm == "ortho":
        s0 = np.full(64, np.sqrt(1 / 128.0)); s0[0] = np.sqrt(1 / 256.0)
        s1 = np.full(128, np.sqrt(1 / 256.0)); s1[0] = np.sqrt(1 / 512.0)
        want = want * s0[:, None] * s1[None, :]
    assert np.max(np.abs(got - want)) < 1e-2


@pytest.mark.parametrize("type", [1, 2, 3, 4])
def test_dctn_idctn_roundtrip(rng, type):
    n = 65 if type == 1 else 64
    x = (rng.random((n, n)) - 0.5).astype(np.float32)
    back = np.asarray(D.idctn(D.dctn(jnp.asarray(x), type=type),
                              type=type))
    assert np.max(np.abs(back - x)) < 2e-4


def test_dstn_idstn_roundtrip(rng):
    x = (rng.random((64, 64)) - 0.5).astype(np.float32)
    back = np.asarray(D.idstn(D.dstn(jnp.asarray(x), type=2, norm="ortho"),
                              type=2, norm="ortho"))
    assert np.max(np.abs(back - x)) < 2e-4


def test_dctn_axes_subset(rng):
    """dctn over one axis == dct over that axis."""
    x = (rng.random((3, 64, 128)) - 0.5).astype(np.float32)
    got = np.asarray(D.dctn(jnp.asarray(x), axes=(1,)))
    want = np.asarray(D.dct(jnp.asarray(np.swapaxes(x, 1, 2))))
    assert np.max(np.abs(got - np.swapaxes(want, 1, 2))) < 1e-5
