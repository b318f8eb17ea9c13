"""Planar public API — every transform on separate fp32 real/imag arrays.

Each function takes and returns PLANAR data — separate fp32 real and
imaginary arrays of shape (..., N) — and runs the same route as the
complex-array API in :mod:`smfft.api` (``backend="auto"``), assembling
and splitting the complex values inside the same traced program.

Layout contracts:
  * C2C: (vr, vi) fp32 (..., N) -> (or, oi) fp32 (..., N); natural
    order when ``ordered=True``; with ``ordered=False`` the matmul
    engine's digit-reversed order (``api.fft(ordered=False)``), which
    :func:`ifft_unordered` consumes.
  * R2C: real (..., N) -> packed planar pair (..., N/2), slot 0 =
    (DC, Nyquist) — the reference's packed layout
    (SMFFT_Stockham_R2C_C2R/FFT-GPU-32bit-Stockham.cu:332-340).  With
    ``ordered=False`` the N/2 packed bins come in the digit-reversed
    order of the N/2-point matmul factorization, which :func:`irfft`
    consumes with ``in_natural=False``.
  * C2R: packed natural pair (..., N/2) -> real (..., N); numpy
    normalization under ``norm="backward"``, the reference's raw
    (N/2)-scale under ``norm=None``.
  * ``fft_any``: rows padded to a multiple of 128 lanes, the signal in
    the first n; padded output lanes are exactly zero.

Batched over any leading shape.  Sizes follow the same static dispatch
contract as :mod:`smfft.api` ("Error wrong FFT length!").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from smfft import api
from smfft import params as P
from smfft.ops import matmul_fft

#: fft_any rows are padded to a multiple of this many lanes
_ANY_ROW_MULTIPLE = 128


def _check_pair(vr, vi):
    if vr.shape != vi.shape:
        raise ValueError(f"planar pair shapes differ: {vr.shape} vs "
                         f"{vi.shape}")


def _complex(vr, vi):
    _check_pair(vr, vi)
    return jax.lax.complex(jnp.asarray(vr, jnp.float32),
                           jnp.asarray(vi, jnp.float32))


def _planar(z):
    return jnp.real(z), jnp.imag(z)


def _check_real_row(n):
    if n not in P.SUPPORTED_REAL_SIZES or n < 256:
        raise ValueError(
            f"Error wrong FFT length! N={n}; planar real transforms "
            f"support {[s for s in P.SUPPORTED_REAL_SIZES if s >= 256]}")


def _half_perm(n):
    """Digit-reversal of the N/2 packed bins: natural[k] = unordered[perm[k]]."""
    return matmul_fft.digit_reverse_indices(n // 2,
                                            P.get_factorization(n // 2))


def fft(vr: jnp.ndarray, vi: jnp.ndarray, ordered: bool = True,
        precision: str | None = None):
    """Planar forward C2C FFT over the last axis."""
    return _planar(api.fft(_complex(vr, vi), ordered=ordered,
                           precision=precision))


def ifft(vr: jnp.ndarray, vi: jnp.ndarray, ordered: bool = True,
         precision: str | None = None, norm: str | None = "backward"):
    """Planar inverse C2C FFT; ``norm="backward"`` divides by N (numpy),
    ``norm=None`` is the reference's unnormalized inverse."""
    return _planar(api.ifft(_complex(vr, vi), ordered=ordered,
                            precision=precision, norm=norm))


def ifft_unordered(vr: jnp.ndarray, vi: jnp.ndarray,
                   precision: str | None = None,
                   norm: str | None = "backward"):
    """Planar inverse consuming the digit-reversed layout
    ``fft(ordered=False)`` produces — the convolution roundtrip pair."""
    return _planar(api.ifft_unordered(_complex(vr, vi), precision=precision,
                                      norm=norm))


def rfft(x: jnp.ndarray, ordered: bool = True,
         precision: str | None = None):
    """Planar R2C: real (..., N) -> packed planar pair (..., N/2) with
    slot 0 = (DC, Nyquist); natural bin order when ``ordered=True``,
    digit-reversed otherwise (pairs with :func:`irfft`'s ``in_natural``)."""
    n = x.shape[-1]
    _check_real_row(n)
    spec = api.fft_packed_real(x, precision=precision)
    if not ordered:
        spec = spec[..., np.argsort(_half_perm(n))]
    return _planar(spec)


def irfft(vr: jnp.ndarray, vi: jnp.ndarray, n: int | None = None,
          precision: str | None = None, norm: str | None = "backward",
          in_natural: bool = True):
    """Planar C2R: packed spectrum pair (..., N/2) -> real (..., N).
    ``in_natural=False`` consumes the digit-reversed layout of
    ``rfft(ordered=False)``."""
    n = n or vr.shape[-1] * 2
    _check_real_row(n)
    spec = _complex(vr, vi)
    if not in_natural:
        spec = spec[..., _half_perm(n)]
    return api.irfft(spec, n=n, precision=precision, norm=norm, packed=True)


def fft_large(vr: jnp.ndarray, vi: jnp.ndarray,
              precision: str | None = None):
    """Planar huge-N forward C2C FFT (N = 2**15..2**28, natural order).
    Row sizes (N <= 16384) route to :func:`fft`."""
    return _planar(api.fft_large(_complex(vr, vi), precision=precision))


def ifft_large(vr: jnp.ndarray, vi: jnp.ndarray,
               precision: str | None = None,
               norm: str | None = "backward"):
    """Planar huge-N inverse C2C FFT; ``norm="backward"`` divides by N,
    ``norm=None`` is the raw unnormalized inverse."""
    return _planar(api.ifft_large(_complex(vr, vi), precision=precision,
                                  norm=norm))


def _check_large_real(n):
    from smfft.ops import fourstep
    fourstep._check_real_n(n)
    if n < 1 << 15:
        raise ValueError(
            f"Error wrong FFT length! N={n}; planar real huge-N "
            f"transforms start at 32768 (use rfft/irfft below)")


def rfft_large(x: jnp.ndarray, precision: str | None = None):
    """Planar huge-N R2C (N = 2**15..2**29): real (..., N) -> packed
    planar half-spectrum pair (..., N/2), slot 0 = (DC, Nyquist).
    Unnormalized, matching :func:`rfft`.  Sizes <= 16384 route to
    :func:`rfft`."""
    n = x.shape[-1]
    if n in P.SUPPORTED_REAL_SIZES and n >= 256:
        return rfft(x, precision=precision)
    _check_large_real(n)
    return _planar(api.rfft_large(x, precision=precision, packed=True))


def irfft_large(vr: jnp.ndarray, vi: jnp.ndarray, n: int | None = None,
                precision: str | None = None,
                norm: str | None = "backward"):
    """Planar huge-N C2R: packed half-spectrum pair (..., N/2) -> real
    (..., N).  ``norm="backward"`` gives the signal; ``norm=None`` keeps
    the reference's raw (N/2) scale."""
    _check_pair(vr, vi)
    n = n or vr.shape[-1] * 2
    if norm not in ("backward", None):
        raise ValueError(
            f"irfft_large supports norm='backward' or norm=None; got "
            f"{norm!r}")
    if n in P.SUPPORTED_REAL_SIZES and n >= 256:
        return irfft(vr, vi, n=n, precision=precision, norm=norm)
    _check_large_real(n)
    return api.irfft_large(_complex(vr, vi), n=n, precision=precision,
                           norm=norm, packed=True)


def convolve(vr: jnp.ndarray, vi: jnp.ndarray, hr: jnp.ndarray,
             hi: jnp.ndarray, precision: str | None = None):
    """Planar circular convolution: ifft(fft(x) * H).  H = (hr, hi) is
    the (N,) frequency response in natural order."""
    return _planar(api.convolve(_complex(vr, vi), _complex(hr, hi),
                                precision=precision))


def fft_any(vr: jnp.ndarray, vi: jnp.ndarray, n: int | None = None,
            precision: str | None = None):
    """Planar arbitrary-length DFT (Bluestein, :mod:`smfft.bluestein`):
    rows are (..., n_pad) with the signal in the first n lanes (n_pad = n
    rounded up to 128); returns the same shape with lanes >= n exactly
    zero.  Pass ``n`` when it is not a multiple of 128."""
    from smfft import bluestein
    _check_pair(vr, vi)
    n = n or vr.shape[-1]
    n_pad = -(-n // _ANY_ROW_MULTIPLE) * _ANY_ROW_MULTIPLE
    if n_pad != vr.shape[-1]:
        raise ValueError(f"expected padded row width {n_pad} "
                         f"for n={n}, got {vr.shape[-1]}")
    out = bluestein.fft_any(_complex(vr[..., :n], vi[..., :n]),
                            precision=precision)
    pad = [(0, 0)] * (out.ndim - 1) + [(0, n_pad - n)]
    return _planar(jnp.pad(out, pad))
