"""Mixed-radix batched FFT as dense DFT-matrix contractions.

A redesign of the reference's butterfly ladder (do_SMFFT_CT_DIT,
SMFFT_CooleyTukey_C2C/FFT-GPU-32bit.cu:334-532 and do_FFT_Stockham_mk6,
SMFFT_Stockham_C2C/FFT-GPU-32bit-Stockham.cu:97-240) at the jnp level:
factor N = r_1 * r_2 * ... * r_s and express each radix-r stage as a
dense contraction with the r-point DFT matrix, with Cooley–Tukey twiddles
applied as element-wise multiplies between stages.  The whole transform
is 1–3 matrix products instead of log2(N) butterfly stages; each stage is
one pass over the batch in device memory.

Digit bookkeeping (derivation in docstring of :func:`_fft_stages`):
  * ``ordered=True``  — each stage prepends its output digit as the new
    most-significant digit ("bmtk" contraction order): the generalized
    Stockham autosort; output is in natural order with **no transpose
    passes** (the reorderings ride inside dot_general operand layouts).
  * ``ordered=False`` — digits append ("bmkt"): output is digit-reversed
    (exactly bit-reversed when all radices are 2; the analogue of the
    reference's ``fft_reorder=0`` cheap path).

Precision: fp32 data with ``precision`` naming the ``lax.Precision`` of
the products (:data:`PRECISIONS`).  Twiddle/DFT tables are computed in
float64 and rounded once to fp32 (vs the reference's fast-math sincosf,
FFT-GPU-32bit.cu:18-28).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from smfft import params as P

#: precision tier -> lax.Precision of the stage products (tier contracts
#: in api.py, above _resolve_precision)
PRECISIONS = {
    "default": jax.lax.Precision.DEFAULT,
    "fast": jax.lax.Precision.HIGH,
    "high": jax.lax.Precision.HIGHEST,
    "highest": jax.lax.Precision.HIGHEST,
    "exact": jax.lax.Precision.HIGHEST,
}


def _dft_c(r: int, sign: float) -> np.ndarray:
    cr, si = P.dft_matrix(r, sign)
    return (cr + 1j * si).astype(np.complex64)


def _tw_c(n: int, radices: tuple[int, ...], sign: float) -> list[np.ndarray]:
    return [
        (c + 1j * s).astype(np.complex64)
        for (c, s) in P.stage_twiddles(n, radices, sign)
    ]


def _fft_stages(x: jnp.ndarray, radices: tuple[int, ...], sign: float,
                ordered: bool, precision) -> jnp.ndarray:
    """Run the mixed-radix stage ladder on x: (B, N) complex.

    Derivation (N = R*C, A[r, c] = x[r*C + c]):
        X[k1 + R*k2] = sum_c w_C^{c k2} [ w_N^{c k1} sum_r A[r,c] w_R^{r k1} ]
    i.e. contract the leading input digit with DFT_R, multiply the twiddle
    w_N^{m * k1} over the remaining index m, recurse on the remaining
    length.  Output digit k_i from stage i is *less* significant than all
    later digits, so natural order requires digits to accumulate
    most-significant-first ("bmtk"); appending them ("bmkt") instead yields
    digit-reversed output for free.
    """
    b, n = x.shape
    assert math.prod(radices) == n
    tws = _tw_c(n, radices, sign)
    state = x.reshape(b, n, 1)  # (B, remaining, done-digits)
    rem = n
    for i, r in enumerate(radices):
        m = rem // r
        k = state.shape[2]
        state = state.reshape(b, r, m, k)
        f = _dft_c(r, sign)
        pattern = "brmk,rt->bmtk" if ordered else "brmk,rt->bmkt"
        state = jnp.einsum(pattern, state, f, precision=precision)
        if i < len(radices) - 1:
            tw = tws[i]  # (m, r): w_rem^{m*t}
            state = state * (tw[None, :, :, None] if ordered
                             else tw[None, :, None, :])
        state = state.reshape(b, m, r * k)
        rem = m
    return state.reshape(b, n)


@partial(jax.jit, static_argnames=("radices", "inverse", "ordered", "precision"))
def _fft_jit(x, radices, inverse, ordered, precision):
    sign = +1.0 if inverse else -1.0
    return _fft_stages(x, radices, sign, ordered, PRECISIONS[precision])


def fft_matmul(x: jnp.ndarray, inverse: bool = False, ordered: bool = True,
               radices: tuple[int, ...] | None = None,
               precision: str = "highest") -> jnp.ndarray:
    """Batched mixed-radix C2C FFT as DFT-matrix contractions.

    Args:
      x: complex64 array (..., N), N in SUPPORTED_C2C_SIZES (or any size
         whose radix split is supplied explicitly).
      inverse: unnormalized positive-exponent transform if True.
      ordered: natural-order output; False gives digit-reversed output
         (bit-reversed under all-radix-2 splits) at lower cost.
      radices: override the plan's radix split.
      precision: a key of :data:`PRECISIONS`.
    """
    n = x.shape[-1]
    if radices is None:
        radices = P.get_factorization(n)
    batch_shape = x.shape[:-1]
    flat = x.reshape((-1, n)).astype(jnp.complex64)
    out = _fft_jit(flat, tuple(radices), inverse, ordered, precision)
    return out.reshape(batch_shape + (n,))


def digit_reverse_indices(n: int, radices: tuple[int, ...]) -> np.ndarray:
    """Permutation mapping the unordered (digit-reversed) output to natural
    order: ordered[k] = unordered[perm[k]].  Generalizes the reference's
    bit-reversal (FFT-GPU-32bit.cu:54-124) to mixed radices."""
    # The unordered array u is indexed by the digit tuple (k1, ..., ks)
    # (shape = radices, row-major) and holds X at true frequency
    # k = k1 + r1*(k2 + r2*(...)), i.e. the flattening of (ks, ..., k1).
    u_idx = np.arange(n).reshape(radices)
    return np.transpose(
        u_idx, tuple(reversed(range(len(radices))))).reshape(-1)
