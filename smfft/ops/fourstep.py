"""Four-step (Bailey) decomposition: huge power-of-two C2C FFTs out of
batched row transforms.

The reference library caps at N = 4096 — the size of one CUDA block's
shared memory (SMFFT_CooleyTukey_C2C/FFT-GPU-32bit.cu:599-659; anything
larger prints "Error wrong FFT length!").  This module removes the cap:
factor N = N1 * N2 with both factors supported row sizes, and compute
the length-N transform as two batches of row transforms glued by one
exact twiddle multiply and transposes:

    A[n1, n2] = x[n1*N2 + n2]                    # reshape, free
    B[n2, k1] = FFT_N1(A[:, n2])                 # row FFTs of A^T
    B[n2, k1] *= W_N^(n2*k1)                     # twiddle (exact, below)
    C[k1, k2] = FFT_N2(B[:, k1])                 # row FFTs of B^T
    X[k2*N1 + k1] = C[k1, k2]                    # transpose + reshape

This is the classic six-step formulation (transpose / FFT / twiddle /
transpose / FFT / transpose); XLA fuses the twiddle into the surrounding
passes.  Both local (fft_four_step: one device, N up to 2**28) and
distributed (parallel/distributed.py: N1 and N2 sharded over the mesh,
all_to_all transposes between devices) entry points ride the same math.

Twiddle exactness: the naive fp32 angle 2*pi*n2*k1/N loses ~8 bits at
N = 2**28 (n2*k1 is not representable).  Instead the exponent is reduced
with EXACT modular arithmetic — N is a power of two, and uint32 multiply
wraps mod 2**32, so (n2 * k1) & (N-1) is the true n2*k1 mod N for any
N <= 2**32 — and the root W_N^m is split as W_N^(hi<<LO) * W_N^lo from
two fp64-computed, fp32-rounded tables of <= 2**14 entries each (same
table discipline as params.stage_twiddles).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from smfft import params as P

#: low-table width: 2**14 entries, the largest supported row size.
_LO_BITS = 14

#: largest local four-step size: 16384 * 16384.
MAX_FOUR_STEP = 1 << 28


def split_factors(n: int, min_factor: int = 32) -> tuple[int, int]:
    """Balanced N = N1 * N2 split with both factors supported row sizes.

    Raises the reference-style size error when n is not a power of two,
    too small to split (< min_factor**2), or beyond 2**28.
    """
    if n <= 0 or (n & (n - 1)) != 0 or n > MAX_FOUR_STEP \
            or n < min_factor * min_factor:
        raise ValueError(
            f"Error wrong FFT length! N={n}; four-step supports powers of "
            f"two in [{min_factor * min_factor}, {MAX_FOUR_STEP}]")
    k = n.bit_length() - 1
    k1 = (k + 1) // 2
    n1, n2 = 1 << k1, 1 << (k - k1)
    assert n1 in P.SUPPORTED_C2C_SIZES and n2 in P.SUPPORTED_C2C_SIZES
    return n1, n2


@functools.lru_cache(maxsize=None)
def _twiddle_tables(n: int, inverse: bool):
    """Planar (lo_r, lo_i, hi_r, hi_i) float32 tables: W_N^j for
    j < 2**lo_bits and W_N^(i << lo_bits), fp64-computed then fp32-rounded
    (cf. params.stage_twiddles), as separate real/imag float32 arrays
    from which the hi * lo products are formed on the device."""
    lo_bits = min(_LO_BITS, n.bit_length() - 1)
    sign = 2j * np.pi / n if inverse else -2j * np.pi / n
    t_lo = np.exp(sign * np.arange(1 << lo_bits))
    t_hi = np.exp(sign * (np.arange(n >> lo_bits) << lo_bits))
    return (t_lo.real.astype(np.float32), t_lo.imag.astype(np.float32),
            t_hi.real.astype(np.float32), t_hi.imag.astype(np.float32))


def twiddle_rows(b: jnp.ndarray, n2_global: jnp.ndarray, n: int,
                 inverse: bool) -> jnp.ndarray:
    """Multiply B[..., r, k1] by W_N^(n2_global[r] * k1), exactly.

    ``n2_global`` carries each local row's GLOBAL second index (the
    distributed path passes the shard offset); k1 ranges over the full
    last axis.  Exponent reduction is exact uint32 wraparound (see module
    docstring)."""
    n1 = b.shape[-1]
    lo_bits = min(_LO_BITS, n.bit_length() - 1)
    lo_r, lo_i, hi_r, hi_i = (jnp.asarray(t)
                              for t in _twiddle_tables(n, inverse))
    m = (n2_global.astype(jnp.uint32)[:, None]
         * jnp.arange(n1, dtype=jnp.uint32)[None, :]) & jnp.uint32(n - 1)
    ih = (m >> lo_bits).astype(jnp.int32)
    il = (m & jnp.uint32((1 << lo_bits) - 1)).astype(jnp.int32)
    tw_r = hi_r[ih] * lo_r[il] - hi_i[ih] * lo_i[il]
    tw_i = hi_r[ih] * lo_i[il] + hi_i[ih] * lo_r[il]
    return b * jax.lax.complex(tw_r, tw_i)


def _half_root_planar(n: int, inverse: bool):
    """Planar (wr, wi) float32 arrays of W_N^k for k in [0, N/2): the
    split/merge twiddle of the real-transform pack trick at four-step
    scale, assembled on device from the same exact hi/lo tables as
    :func:`twiddle_rows` (k < N needs no modular reduction)."""
    lo_bits = min(_LO_BITS, n.bit_length() - 1)
    lo_r, lo_i, hi_r, hi_i = (jnp.asarray(t)
                              for t in _twiddle_tables(n, inverse))
    k = jnp.arange(n // 2, dtype=jnp.uint32)
    ih = (k >> lo_bits).astype(jnp.int32)
    il = (k & jnp.uint32((1 << lo_bits) - 1)).astype(jnp.int32)
    wr = hi_r[ih] * lo_r[il] - hi_i[ih] * lo_i[il]
    wi = hi_r[ih] * lo_i[il] + hi_i[ih] * lo_r[il]
    return wr, wi


def _check_real_n(n: int):
    if n <= 0 or (n & (n - 1)) != 0 or not 64 <= n <= 2 * MAX_FOUR_STEP:
        raise ValueError(
            f"Error wrong FFT length! N={n}; four-step real transforms "
            f"support powers of two in [64, {2 * MAX_FOUR_STEP}]")


def _half_fft(z: jnp.ndarray, inverse: bool, backend: str,
              precision: str | None) -> jnp.ndarray:
    """Length-L complex transform (row transform when L is a supported row
    size, four-step above), UNNORMALIZED both directions."""
    if z.shape[-1] in P.SUPPORTED_C2C_SIZES:
        return _row_fft(z, inverse, backend, precision)
    return fft_four_step(z, inverse=inverse, backend=backend,
                         precision=precision)


def rfft_four_step(x: jnp.ndarray, *, packed: bool = False,
                   backend: str = "auto",
                   precision: str | None = None) -> jnp.ndarray:
    """Huge-N R2C via the reference's half-size pack trick
    (SMFFT_Stockham_R2C_C2R/FFT-GPU-32bit-Stockham.cu:269-344) applied at
    four-step scale: pack (even, odd) -> length-L complex transform
    (four-step above the row cap) -> Hermitian split with EXACT W_N^k
    twiddles from the hi/lo tables.  Real (..., N) -> complex
    (..., N/2+1) numpy layout, or the reference's packed (..., N/2)
    layout with out[..., 0] = DC + 1j*Nyquist."""
    n = x.shape[-1]
    _check_real_n(n)
    z = jax.lax.complex(x[..., 0::2].astype(jnp.float32),
                        x[..., 1::2].astype(jnp.float32))
    zf = _half_fft(z, False, backend, precision)
    zr, zi = jnp.real(zf), jnp.imag(zf)
    zrr = jnp.roll(jnp.flip(zr, axis=-1), 1, axis=-1)    # Re Z[(L-k)%L]
    zri = jnp.roll(jnp.flip(zi, axis=-1), 1, axis=-1)
    er, ei = 0.5 * (zr + zrr), 0.5 * (zi - zri)          # (Z+conj(Zrev))/2
    or_, oi = 0.5 * (zi + zri), 0.5 * (zrr - zr)         # -i(Z-conj)/2
    wr, wi = _half_root_planar(n, False)
    fr = er + wr * or_ - wi * oi                         # X[0..L-1]
    fi = ei + wr * oi + wi * or_
    dc = zr[..., :1] + zi[..., :1]
    nyq = zr[..., :1] - zi[..., :1]
    if packed:
        return jax.lax.complex(
            jnp.concatenate([dc, fr[..., 1:]], axis=-1),
            jnp.concatenate([nyq, fi[..., 1:]], axis=-1))
    zero = jnp.zeros_like(dc)
    return jax.lax.complex(
        jnp.concatenate([dc, fr[..., 1:], nyq], axis=-1),
        jnp.concatenate([zero, fi[..., 1:], zero], axis=-1))


def irfft_four_step(spec: jnp.ndarray, n: int, *, packed: bool = False,
                    backend: str = "auto", precision: str | None = None,
                    normalize: bool = False) -> jnp.ndarray:
    """Huge-N C2R inverse of :func:`rfft_four_step`.  Returns the
    reference's raw (N/2)-scaled signal
    (SMFFT_Stockham_R2C_C2R/FFT.c:170-171) unless ``normalize``."""
    _check_real_n(n)
    L = n // 2
    sr, si = jnp.real(spec), jnp.imag(spec)
    zero = jnp.zeros_like(sr[..., :1])
    if packed:
        dc, nyq = sr[..., :1], si[..., :1]
        br, bi = sr[..., 1:], si[..., 1:]
    else:
        dc, nyq = sr[..., :1], sr[..., L:L + 1]
        br, bi = sr[..., 1:L], si[..., 1:L]
    xr = jnp.concatenate([dc, br], axis=-1)              # X[0..L-1]
    xi = jnp.concatenate([zero, bi], axis=-1)
    mr = jnp.concatenate([nyq, jnp.flip(br, axis=-1)], axis=-1)
    mi = jnp.concatenate([zero, jnp.flip(bi, axis=-1)], axis=-1)
    # E = (X+conj(M))/2, O = (X-conj(M))/2 * W_N^{+k}, Z = E + iO
    er, ei = 0.5 * (xr + mr), 0.5 * (xi - mi)
    tr, ti = 0.5 * (xr - mr), 0.5 * (xi + mi)
    wr, wi = _half_root_planar(n, True)
    or_, oi = tr * wr - ti * wi, tr * wi + ti * wr
    z = jax.lax.complex(er - oi, ei + or_)
    zf = _half_fft(z, True, backend, precision)
    out = jnp.stack([jnp.real(zf), jnp.imag(zf)], axis=-1).reshape(
        spec.shape[:-1] + (n,))
    if normalize:
        out = out / L
    return out


def _row_fft(x: jnp.ndarray, inverse: bool, backend: str,
             precision: str | None) -> jnp.ndarray:
    """Ordered row transform; the inverse stays UNNORMALIZED (the 1/N of
    a backward-norm inverse is applied once at the top level)."""
    from smfft import api
    if inverse:
        return api.ifft(x, backend=backend, precision=precision, norm=None)
    return api.fft(x, backend=backend, precision=precision)


def fft_four_step(x: jnp.ndarray, *, inverse: bool = False,
                  backend: str = "auto", precision: str | None = None,
                  factors: tuple[int, int] | None = None,
                  scale: float = 1.0) -> jnp.ndarray:
    """Single-device C2C FFT over the last axis for huge power-of-two N
    (beyond the 16384 row cap, up to 2**28) via the four-step
    decomposition.  Batched over any leading axes.  Unnormalized both
    directions unless ``scale`` (e.g. 1/N for numpy backward-norm
    inverses) is given."""
    n = x.shape[-1]
    n1, n2 = factors if factors is not None else split_factors(n)
    if n1 * n2 != n:
        raise ValueError(f"factors {n1}*{n2} != N={n}")
    a = x.reshape(x.shape[:-1] + (n1, n2))
    # columns -> rows: FFT over n1
    b = _row_fft(jnp.swapaxes(a, -1, -2), inverse, backend, precision)
    b = twiddle_rows(b, jnp.arange(n2, dtype=jnp.uint32), n, inverse)
    # columns -> rows: FFT over n2
    c = _row_fft(jnp.swapaxes(b, -1, -2), inverse, backend, precision)
    # X[k2*N1 + k1] = C[k1, k2]
    out = jnp.swapaxes(c, -1, -2).reshape(x.shape[:-1] + (n,))
    return out * scale if scale != 1.0 else out
