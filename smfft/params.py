"""Static FFT plan system — the analogue of the reference's L0 layer.

The reference encodes every (size, direction, reorder) combination as a
separate template-parameter class with ``static const int`` members
(``fft_exp``, ``fft_length``, ``fft_sm_required``, ``fft_direction``,
``fft_reorder``; reference SMFFT_CooleyTukey_C2C/SM_FFT_parameters.cuh:1-390)
so that the CUDA compiler fully specializes every kernel.  Here the same
role is played by a frozen, hashable :class:`FFTParams` dataclass used as a
``jax.jit`` static argument: every distinct plan traces and compiles its own
fully-specialized XLA program, with twiddle-factor tables baked in as
compile-time constants.

Unlike the reference, twiddles are *precomputed* in float64 and rounded to
fp32 (the reference recomputes ``sincosf`` per butterfly under
``--use_fast_math``, SMFFT_CooleyTukey_C2C/FFT-GPU-32bit.cu:18-28 and
Makefile:7), which is more accurate and is what lets the library meet a
tighter error budget than the reference's 1e-4.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Literal

import numpy as np

# --------------------------------------------------------------------------
# Supported sizes.
#
# Reference coverage: C2C N = 32..4096 (SM_FFT_parameters.cuh:1-390 defines
# classes for 32,64,...,4096; Stockham C2C dispatches 256..4096,
# SMFFT_Stockham_C2C/FFT-GPU-32bit-Stockham.cu:317-341), real transforms
# N = 512..4096 (half-size 256..2048,
# SMFFT_Stockham_R2C_C2R/FFT-GPU-32bit-Stockham.cu:406-427).
# We support the union, extend real sizes down to 64 and up to 16384
# (half-size 32..8192) since the half-size C2C core covers them, and
# extend C2C to 16384 (the reference's 4096 cap was its 48 KB of shared
# memory per block; nothing here holds a row in on-chip memory).
# --------------------------------------------------------------------------

SUPPORTED_C2C_SIZES: tuple[int, ...] = (32, 64, 128, 256, 512, 1024, 2048,
                                        4096, 8192, 16384)
SUPPORTED_REAL_SIZES: tuple[int, ...] = (64, 128, 256, 512, 1024, 2048,
                                         4096, 8192, 16384)

Direction = Literal["forward", "inverse"]
Kind = Literal["c2c", "r2c", "c2r"]

# --------------------------------------------------------------------------
# Radix factorization table.
#
# Each C2C size is computed as a sequence of mixed-radix stages; each stage
# contracts one digit axis with a dense DFT_r matrix.  The choice trades
# FLOPs (8*N*sum(radices) real flops per FFT) against stage count (one
# pass over the batch per stage).  The split also defines the
# digit-reversed ``ordered=False`` layout (matmul_fft.digit_reverse_indices),
# so changing it changes that layout; override via `set_factorization`
# before building plans.
# --------------------------------------------------------------------------

_DEFAULT_FACTORS: dict[int, tuple[int, ...]] = {
    32: (32,),
    64: (64,),
    128: (16, 8),
    256: (16, 16),
    512: (32, 16),
    1024: (32, 32),
    2048: (64, 32),
    4096: (16, 16, 16),
    8192: (32, 16, 16),
    16384: (32, 32, 16),
}

_FACTORS = dict(_DEFAULT_FACTORS)


def set_factorization(n: int, radices: tuple[int, ...]) -> None:
    """Override the radix split used for size ``n`` (affects new plans only)."""
    if math.prod(radices) != n:
        raise ValueError(f"prod{radices} != {n}")
    _FACTORS[n] = tuple(int(r) for r in radices)
    plan_for.cache_clear()
    stage_twiddles.cache_clear()
    dft_matrix.cache_clear()


def get_factorization(n: int) -> tuple[int, ...]:
    return _FACTORS[n]


def reset_factorizations() -> None:
    _FACTORS.clear()
    _FACTORS.update(_DEFAULT_FACTORS)
    plan_for.cache_clear()
    stage_twiddles.cache_clear()
    dft_matrix.cache_clear()


# --------------------------------------------------------------------------
# The plan object.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FFTParams:
    """Frozen, hashable FFT plan — jit static-argument analogue of FFT_Params.

    Attributes mirror the reference's compile-time members
    (SM_FFT_parameters.cuh:1-18):

    * ``n``         — transform length (complex length for c2c; for r2c/c2r
                      this is the *real* signal length, and the internal
                      half-size complex core runs at n//2, mirroring
                      SMFFT_Stockham_R2C_C2R's half-size template dispatch at
                      FFT-GPU-32bit-Stockham.cu:406-427).
    * ``exp``       — log2(n)  (reference ``fft_exp``).
    * ``direction`` — "forward" | "inverse" (reference ``fft_direction``
                      0/1; note the reference's FFT_4096_inverse_noreorder
                      direction bug, SM_FFT_parameters.cuh:380-389, which we
                      do *not* replicate).
    * ``kind``      — "c2c" | "r2c" | "c2r" (the reference's three variant
                      directories collapsed into one axis).
    * ``ordered``   — natural-order output if True; digit-reversed if False
                      (reference ``fft_reorder``; the Stockham variants are
                      always ordered, README.md:33-36).
    * ``radices``   — the mixed-radix stage split (replaces the reference's
                      hard-wired radix-2 stage ladder).
    """

    n: int
    direction: Direction = "forward"
    kind: Kind = "c2c"
    ordered: bool = True
    radices: tuple[int, ...] = ()

    def __post_init__(self):
        if self.kind == "c2c":
            if self.n not in SUPPORTED_C2C_SIZES:
                raise ValueError(
                    f"Error wrong FFT length! c2c n={self.n} not in "
                    f"{SUPPORTED_C2C_SIZES}"
                )
        else:
            if self.n not in SUPPORTED_REAL_SIZES:
                raise ValueError(
                    f"Error wrong FFT length! {self.kind} n={self.n} not in "
                    f"{SUPPORTED_REAL_SIZES}"
                )
        core_n = self.n if self.kind == "c2c" else self.n // 2
        if not self.radices:
            object.__setattr__(self, "radices", _FACTORS[core_n])
        if math.prod(self.radices) != core_n:
            raise ValueError(f"prod{self.radices} != core size {core_n}")

    @property
    def exp(self) -> int:
        return self.n.bit_length() - 1

    @property
    def core_n(self) -> int:
        """Length of the underlying complex transform."""
        return self.n if self.kind == "c2c" else self.n // 2

    @property
    def sign(self) -> float:
        """Twiddle exponent sign: -1 forward (e^{-2πi nk/N}), +1 inverse."""
        return -1.0 if self.direction == "forward" else +1.0


@lru_cache(maxsize=None)
def plan_for(
    n: int,
    direction: Direction = "forward",
    kind: Kind = "c2c",
    ordered: bool = True,
) -> FFTParams:
    """Cached plan constructor (the dispatch-table analogue of the reference's
    32-case static switch, SMFFT_CooleyTukey_C2C/FFT-GPU-32bit.cu:599-659)."""
    return FFTParams(n=n, direction=direction, kind=kind, ordered=ordered)


# --------------------------------------------------------------------------
# Twiddle / DFT-matrix tables (float64-accurate, rounded to fp32).
# --------------------------------------------------------------------------


@lru_cache(maxsize=None)
def dft_matrix(r: int, sign: float, dtype: str = "float32"):
    """Dense DFT matrix F[q, t] = exp(sign * 2πi * q t / r), split (re, im).

    Returned as two float arrays so callers can build either planar or
    interleaved real representations.  Computed in float64, rounded once.
    """
    q = np.arange(r, dtype=np.float64)[:, None]
    t = np.arange(r, dtype=np.float64)[None, :]
    ang = sign * 2.0 * np.pi * (q * t % r) / r
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


@lru_cache(maxsize=None)
def stage_twiddles(n: int, radices: tuple[int, ...], sign: float,
                   dtype: str = "float32"):
    """Per-stage twiddle tables for the mixed-radix decomposition.

    Stage i (radix r_i, remaining length P_i = prod(radices[i:])) applies
    tw[m, t] = exp(sign * 2πi * m * t / P_i) with m over the remaining
    length P_i / r_i and t over the new output digit (0..r_i).  Stage s-1's
    table is all-ones and omitted (twiddle of the last stage is trivial) —
    this is the tensor-algebra form of the Cooley–Tukey twiddle, replacing
    the reference's per-butterfly sincosf (FFT-GPU-32bit.cu:383-411).

    Returns a tuple of (cos, sin) float pairs, one per non-trivial stage.
    """
    assert math.prod(radices) == n
    out = []
    rem = n
    for r in radices[:-1]:
        m = np.arange(rem // r, dtype=np.float64)[:, None]
        t = np.arange(r, dtype=np.float64)[None, :]
        ang = sign * 2.0 * np.pi * (m * t) / rem
        out.append((np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)))
        rem //= r
    return tuple(out)


@lru_cache(maxsize=None)
def real_split_twiddles(n: int, dtype: str = "float32"):
    """Twiddles W_n^k = exp(-2πi k / n), k = 0..n/4? no: k over half length.

    Used by the r2c/c2r split/merge post-process (reference
    SMFFT_Stockham_R2C_C2R/FFT-GPU-32bit-Stockham.cu:289-328): for real
    length ``n`` the half-size spectrum of length L = n/2 is recombined with
    W(n, k) for k = 0..L-1.  Float64-computed, fp32-rounded.
    """
    L = n // 2
    k = np.arange(L, dtype=np.float64)
    ang = -2.0 * np.pi * k / n
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)
