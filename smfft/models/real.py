"""Real-transform family (R2C / C2R) via the half-size packing trick — spec.

Mirrors the reference's ``do_FFT_Stockham_R2C_C2R``
(SMFFT_Stockham_R2C_C2R/FFT-GPU-32bit-Stockham.cu:269-344): a real transform
of length N is computed as a complex transform of length L = N/2 on packed
(even, odd) samples, followed by a split/merge post-process with W(N, k)
twiddles (:289-328), with element 0 packing the two purely-real spectrum
values DC and Nyquist as (re, im) of a single complex slot (:332-340).

Math (derived independently; see any standard text):
  E[m] = x[2m], O[m] = x[2m+1], Z = DFT_L(E + iO)
  Ê[k] = (Z[k] + conj(Z[-k]))/2,  Ô[k] = (Z[k] - conj(Z[-k]))/(2i)
  X[k] = Ê[k] + W_N^k Ô[k]  for k = 0..L,   X[L] = Ê[0] - Ô[0]

Two output layouts are provided:
  * ``packed=False`` (default): numpy-compatible ``(..., L+1)`` rfft layout.
  * ``packed=True``: the reference's L-slot layout with
    ``out[..., 0] = DC + 1j*Nyquist`` (FFT-GPU-32bit-Stockham.cu:332-340),
    which keeps the array length a power of two.

Normalization: like the reference, the C2R inverse is *unnormalized* — it
returns ``(N/2) * x`` (the harness divides by N/2 when comparing,
SMFFT_Stockham_R2C_C2R/FFT.c:170-171).  Pass ``normalize=True`` for the
convenience scaling.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from smfft.models.stockham import fft_stockham


def pack_real(x: jnp.ndarray) -> jnp.ndarray:
    """Interleave a real signal (..., N) into complex (..., N/2): even + i*odd."""
    x = x.astype(jnp.float32)
    return x[..., 0::2] + 1j * x[..., 1::2]


def _split_forward(z: jnp.ndarray, n: int, packed: bool) -> jnp.ndarray:
    """Post-process half-size spectrum Z (..., L) into the real spectrum."""
    L = n // 2
    zrev = jnp.roll(jnp.flip(z, axis=-1), 1, axis=-1)  # Z[(L-k) mod L]
    e = 0.5 * (z + jnp.conj(zrev))
    o = -0.5j * (z - jnp.conj(zrev))
    k = np.arange(L)
    w = np.exp(-2j * np.pi * k / n).astype(np.complex64)
    full = e + w * o                       # X[0..L-1]
    dc = jnp.real(z[..., :1]) + jnp.imag(z[..., :1])       # X[0] = Re+Im of Z[0]
    nyq = jnp.real(z[..., :1]) - jnp.imag(z[..., :1])      # X[L] = Re-Im of Z[0]
    if packed:
        head = dc + 1j * nyq
        return jnp.concatenate([head, full[..., 1:]], axis=-1)
    return jnp.concatenate([dc + 0j, full[..., 1:], nyq + 0j], axis=-1)


def rfft_spec(x: jnp.ndarray, packed: bool = False) -> jnp.ndarray:
    """Batched R2C spec: real (..., N) -> complex (..., N/2+1) or packed (..., N/2)."""
    n = x.shape[-1]
    z = pack_real(x)
    zf = fft_stockham(z, inverse=False)
    return _split_forward(zf, n, packed)


def _merge_inverse(spec: jnp.ndarray, n: int, packed: bool) -> jnp.ndarray:
    """Pre-process the real spectrum back into the half-size complex spectrum Z."""
    L = n // 2
    if packed:
        dc = jnp.real(spec[..., :1])
        nyq = jnp.imag(spec[..., :1])
        x_half = jnp.concatenate([dc + 0j, spec[..., 1:]], axis=-1)  # X[0..L-1]
    else:
        dc = jnp.real(spec[..., :1])
        nyq = jnp.real(spec[..., L:L + 1])
        x_half = jnp.concatenate([dc + 0j, spec[..., 1:L]], axis=-1)
    # X[(L-k) mod L] over k=0..L-1 needs X[L] at k=0's mirror... note
    # mirror[k] = X[L-k]; for k=0 that is X[L] (Nyquist), else X[L-k].
    body = spec[..., 1:L]
    mirror = jnp.concatenate([nyq + 0j, jnp.flip(body, axis=-1)], axis=-1)
    k = np.arange(L)
    winv = np.exp(+2j * np.pi * k / n).astype(np.complex64)
    e = 0.5 * (x_half + jnp.conj(mirror))
    o = 0.5 * (x_half - jnp.conj(mirror)) * winv
    return e + 1j * o


def irfft_spec(spec: jnp.ndarray, n: int, packed: bool = False,
               normalize: bool = False) -> jnp.ndarray:
    """Batched C2R spec. Returns (N/2)*x unless ``normalize`` (reference contract)."""
    z = _merge_inverse(spec, n, packed)
    zi = fft_stockham(z, inverse=True)  # unnormalized inverse, scale L
    out = jnp.stack([jnp.real(zi), jnp.imag(zi)], axis=-1).reshape(
        spec.shape[:-1] + (n,))
    if normalize:
        out = out / (n // 2)
    return out


def packed_to_numpy_layout(spec_packed: jnp.ndarray) -> jnp.ndarray:
    """Convert the reference's packed L-slot layout to numpy's (L+1) layout."""
    dc = jnp.real(spec_packed[..., :1]) + 0j
    nyq = jnp.imag(spec_packed[..., :1]) + 0j
    return jnp.concatenate([dc, spec_packed[..., 1:], nyq], axis=-1)


def numpy_to_packed_layout(spec: jnp.ndarray) -> jnp.ndarray:
    """Convert numpy's (L+1) rfft layout to the reference's packed L-slot layout."""
    head = jnp.real(spec[..., :1]) + 1j * jnp.real(spec[..., -1:])
    return jnp.concatenate([head, spec[..., 1:-1]], axis=-1)
