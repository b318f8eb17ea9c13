"""Cooley–Tukey radix-2 DIT family — semantic spec.

Mirrors the *contract* of the reference's ``do_SMFFT_CT_DIT`` core
(SMFFT_CooleyTukey_C2C/FFT-GPU-32bit.cu:334-532): batched power-of-two
radix-2 decimation-in-time C2C transforms, forward and inverse, with output
either in natural order (reference ``fft_reorder=1``, which bit-reverses the
*input* before the DIT ladder, FFT-GPU-32bit.cu:352-361) or in bit-reversed
order (``fft_reorder=0``, the cheap path the reference leaves unverified,
SMFFT_CooleyTukey_C2C/FFT.c:161-163 — we verify it here via the permutation
contract).

This module is the executable specification, not the fast path: a recursive
radix-2 DIT vectorized over the batch, written so its correctness is obvious
and checkable against ``numpy.fft`` at a glance.  The engines in
:mod:`smfft.api` are tested against it.

Note: the reference's ``FFT_4096_inverse_noreorder`` plan silently runs
*forward* due to a direction typo (SM_FFT_parameters.cuh:380-389).  That bug
is intentionally not replicated.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def bit_reverse_indices(n: int) -> np.ndarray:
    """Permutation p with p[i] = bit-reversal of i in log2(n) bits.

    The index network the reference implements with ``__brev``-computed warp
    shuffle targets and 33-stride padded shared-memory staging
    (FFT-GPU-32bit.cu:54-329); here a static gather serves the same role.
    """
    exp = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(exp):
        rev |= ((idx >> b) & 1) << (exp - 1 - b)
    return rev


def fft_dit(x: jnp.ndarray, inverse: bool = False, ordered: bool = True) -> jnp.ndarray:
    """Batched radix-2 DIT C2C FFT spec.

    Args:
      x: complex array (..., N), N a power of two.
      inverse: positive-exponent (unnormalized) transform if True — the
        reference never normalizes its inverse (SURVEY.md quirk 3).
      ordered: natural-order output; if False, output is bit-reversed, i.e.
        ``out[i] == ordered_out[bit_reverse(i)]``.
    """
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError("N must be a power of two")
    sign = +1.0 if inverse else -1.0

    def rec(v: jnp.ndarray) -> jnp.ndarray:
        m = v.shape[-1]
        if m == 1:
            return v
        even = rec(v[..., 0::2])
        odd = rec(v[..., 1::2])
        k = np.arange(m // 2)
        w = np.exp(sign * 2j * np.pi * k / m).astype(np.complex64)
        t = w * odd
        return jnp.concatenate([even + t, even - t], axis=-1)

    out = rec(x)
    if not ordered:
        out = out[..., bit_reverse_indices(n)]
    return out
