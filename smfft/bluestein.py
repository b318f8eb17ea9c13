"""Arbitrary-length FFTs via Bluestein's chirp-z algorithm.

The reference dispatches a fixed set of power-of-two sizes and prints
"Error wrong FFT length!" for everything else
(SMFFT_CooleyTukey_C2C/FFT-GPU-32bit.cu:656-658).  This module removes
that restriction on top of the power-of-two transforms: an n-point DFT of ANY
length is a chirp multiply, one circular convolution of a supported
power-of-two length m >= 2n-1, and a second chirp multiply —

    X_k = w_k * sum_j (x_j * w_j) * conj(w)_{k-j},   w_j = e^{-i pi j^2 / n}

and the convolution is :func:`smfft.api.convolve` (FFT -> filter ->
IFFT at length m), with the chirp multiplies fused by XLA into the
neighbouring passes.  The chirp filter's frequency response is
precomputed per n in float64 on the host (exact integer reduction of
j^2 mod 2n keeps the phase exact at any n).

``czt`` generalizes to scipy.signal-style chirp-z evaluation along a
spiral contour (m output points, ratio w, start a).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from smfft import api
from smfft import params as P

_MAX_M = max(P.SUPPORTED_C2C_SIZES)


def _conv_length(total: int) -> int:
    """Smallest supported power-of-two >= total (the circular length)."""
    m = max(32, 1 << (total - 1).bit_length())
    if m not in P.SUPPORTED_C2C_SIZES:
        raise ValueError(
            f"Error wrong FFT length! Bluestein needs a supported "
            f"convolution length >= {total}; max n is {_MAX_M // 2}")
    return m


@functools.lru_cache(maxsize=None)
def _bluestein_consts(n: int):
    """(m, chirp (n,), filter response (m,)) — float64 host math.

    The chirp phase -pi*j^2/n is reduced with INTEGER j^2 mod 2n, so it
    is exact for any n (naive fp64 j^2 loses ~1e-7 rad at n ~ 8192)."""
    m = _conv_length(2 * n - 1)
    j = np.arange(n, dtype=np.int64)
    ang = -np.pi * ((j * j) % (2 * n)) / n
    w = np.exp(1j * ang)                    # e^{-i pi j^2 / n}
    b = np.zeros(m, np.complex128)
    b[:n] = np.conj(w)
    b[m - n + 1:] = np.conj(w[1:][::-1])    # b[m-j] = b[j] (symmetric)
    fb = np.fft.fft(b)
    # cache NUMPY constants (device arrays created under a jit trace
    # would leak tracers out of the cache)
    return m, w.astype(np.complex64), fb.astype(np.complex64)


def fft_any(x: jnp.ndarray, backend: api.Backend = "auto",
            precision: str | None = None) -> jnp.ndarray:
    """Forward C2C FFT over the last axis at ANY length 1 <= n <= 8192.

    Supported power-of-two sizes dispatch straight to :func:`api.fft`;
    everything else runs Bluestein over :func:`api.convolve`."""
    n = x.shape[-1]
    x = jnp.asarray(x).astype(jnp.complex64)
    if n == 1:
        return x
    if n in P.SUPPORTED_C2C_SIZES:
        return api.fft(x, backend=backend, precision=precision)
    m, w, fb = _bluestein_consts(n)
    w, fb = jnp.asarray(w), jnp.asarray(fb)
    a = x * w
    pad = [(0, 0)] * (x.ndim - 1) + [(0, m - n)]
    a = jnp.pad(a, pad)
    conv = api.convolve(a, fb, backend=backend, precision=precision)
    return conv[..., :n] * w


def ifft_any(x: jnp.ndarray, backend: api.Backend = "auto",
             precision: str | None = None,
             norm: str | None = "backward") -> jnp.ndarray:
    """Inverse C2C FFT at any length (conjugation identity over
    :func:`fft_any`); ``norm="backward"`` divides by n."""
    n = x.shape[-1]
    out = jnp.conj(fft_any(jnp.conj(x), backend=backend,
                           precision=precision))
    if norm == "backward":
        out = out / n
    return out


def rfft_any(x: jnp.ndarray, backend: api.Backend = "auto",
             precision: str | None = None) -> jnp.ndarray:
    """R2C FFT at ANY length 1 <= n <= 8192: real (..., n) -> complex
    (..., n//2 + 1), numpy ``rfft`` layout.

    Supported power-of-two sizes dispatch to :func:`smfft.api.rfft`
    (half the traffic); everything else
    runs the Bluestein chirp-z path and slices the one-sided half."""
    n = x.shape[-1]
    if jnp.iscomplexobj(x):
        raise ValueError("rfft_any expects real input rows")
    if n in P.SUPPORTED_REAL_SIZES:
        return api.rfft(x, backend=backend, precision=precision)
    spec = fft_any(x, backend=backend, precision=precision)
    return spec[..., :n // 2 + 1]


def irfft_any(x: jnp.ndarray, n: int | None = None,
              backend: api.Backend = "auto",
              precision: str | None = None,
              norm: str | None = "backward") -> jnp.ndarray:
    """C2R inverse FFT at ANY length: one-sided (..., n//2 + 1) complex
    -> real (..., n), numpy ``irfft`` semantics (``n`` defaults to
    2*(last-1); ``norm="backward"`` divides by n).

    Supported power-of-two sizes dispatch to :func:`smfft.api.irfft`; other
    lengths rebuild the Hermitian spectrum (one host-built gather + a
    conjugation mask) and ride the Bluestein inverse."""
    if n is None:
        n = (x.shape[-1] - 1) * 2
    if n in P.SUPPORTED_REAL_SIZES:
        return api.irfft(x[..., :n // 2 + 1], n=n, backend=backend,
                         precision=precision, norm=norm)
    h = n // 2
    need = h + 1
    if x.shape[-1] < need:
        raise ValueError(f"spectrum has {x.shape[-1]} bins < {need} "
                         f"needed for n={n}")
    half = x[..., :need]
    # full spectrum: [X_0 .. X_h, conj(X_{n-need}) .. conj(X_1)]
    src = np.zeros(n, np.int64)
    src[:need] = np.arange(need)
    src[need:] = np.arange(n - need, 0, -1)
    sign = np.ones(n, np.float32)
    sign[need:] = -1.0                   # conjugate the mirrored half
    full = half[..., jnp.asarray(src)]
    full = jax.lax.complex(jnp.real(full),
                           jnp.imag(full) * jnp.asarray(sign))
    out = jnp.real(ifft_any(full, backend=backend, precision=precision,
                            norm=None))
    if norm == "backward":
        out = out / n
    return out


@functools.lru_cache(maxsize=None)
def _czt_consts(n: int, m: int, w: complex, a: complex):
    """Host fp64 chirp constants for the general contour: input chirp
    a^{-j} w^{j^2/2} (n,), filter response (L,), output chirp w^{k^2/2}
    (m,)."""
    L = _conv_length(n + m - 1)
    wj = np.asarray(w, np.complex128)
    aj = np.asarray(a, np.complex128)
    j = np.arange(max(n, m), dtype=np.float64)
    logw = np.log(wj)                       # exact spiral handling
    chirp = np.exp(logw * (j * j) / 2.0)    # w^{j^2/2}
    in_chirp = (aj ** -j[:n]) * chirp[:n]
    out_chirp = chirp[:m]
    v = np.zeros(L, np.complex128)
    k = np.arange(m, dtype=np.float64)
    v[:m] = np.exp(-logw * (k * k) / 2.0)   # w^{-k^2/2}
    jj = np.arange(1, n, dtype=np.float64)
    v[L - n + 1:] = np.exp(-logw * (jj * jj) / 2.0)[::-1]
    fv = np.fft.fft(v)
    return (L, in_chirp.astype(np.complex64), fv.astype(np.complex64),
            out_chirp.astype(np.complex64))


def czt(x: jnp.ndarray, m: int | None = None, w: complex | None = None,
        a: complex = 1.0 + 0.0j, backend: api.Backend = "auto",
        precision: str | None = None) -> jnp.ndarray:
    """Chirp-z transform along a spiral contour (scipy.signal.czt
    semantics): X_k = sum_j x_j a^{-j} w^{jk}, k = 0..m-1.

    Defaults (m = n, w = e^{-2 pi i / m}, a = 1) give the DFT.  The
    convolution is :func:`smfft.api.convolve`; constants are fp64-host
    precomputed per (n, m, w, a)."""
    n = x.shape[-1]
    if m is None:
        m = n
    if w is None:
        w = np.exp(-2j * np.pi / m)
    L, in_chirp, fv, out_chirp = _czt_consts(n, m, complex(w), complex(a))
    sig = jnp.asarray(x).astype(jnp.complex64) * jnp.asarray(in_chirp)
    pad = [(0, 0)] * (x.ndim - 1) + [(0, L - n)]
    conv = api.convolve(jnp.pad(sig, pad), jnp.asarray(fv),
                        backend=backend, precision=precision)
    return conv[..., :m] * jnp.asarray(out_chirp)


def zoom_fft(x: jnp.ndarray, fn, m: int | None = None, *, fs: float = 2.0,
             backend: api.Backend = "auto",
             precision: str | None = None) -> jnp.ndarray:
    """Zoomed DFT over a frequency band (scipy.signal.zoom_fft): evaluate
    ``m`` equally spaced bins of the DTFT on [f1, f2] without computing
    the full padded FFT.

    ``fn``: the band — a scalar f2 (band = [0, f2]) or a pair (f1, f2),
    in the same units as ``fs`` (default fs=2 makes frequencies
    fractions of the Nyquist rate).  One chirp-z transform.
    """
    n = x.shape[-1]
    if m is None:
        m = n
    if np.ndim(fn) == 0:
        f1, f2 = 0.0, float(fn)
    else:
        f1, f2 = float(fn[0]), float(fn[1])
    # scipy's endpoint=False convention: bin step (f2 - f1) / (fs * m)
    w = np.exp(-2j * np.pi * (f2 - f1) / (fs * m))
    a = np.exp(2j * np.pi * f1 / fs)
    return czt(x, m=m, w=complex(w), a=complex(a), backend=backend,
               precision=precision)
