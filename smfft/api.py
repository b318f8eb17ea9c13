"""Public API — batched FFT entry points with static size dispatch.

The analogue of the reference's L3 host-driver interface
(GPU_smFFT_4elements / GPU_FFT_C2C_Stockham / GPU_smFFT_R2C / GPU_smFFT_C2R,
SMFFT_CooleyTukey_C2C/FFT-GPU-32bit.cu:827-908,
SMFFT_Stockham_C2C/FFT-GPU-32bit-Stockham.cu:457-530,
SMFFT_Stockham_R2C_C2R/FFT-GPU-32bit-Stockham.cu:572-688) plus its 32-case
static dispatch switch (FFT-GPU-32bit.cu:599-659): unsupported sizes raise
(the reference prints "Error wrong FFT length!", :656-658).

Backends:
  * ``backend="jnp"`` — ``jax.numpy.fft``: cuFFT on an NVIDIA GPU, XLA's
    own FFT on the CPU.  Natural-order layouts only.
  * ``backend="xla"`` — the jnp-level mixed-radix DFT-as-matmul engine
    (ops/matmul_fft.py).  The only engine with the digit-reversed
    ``ordered=False`` layout.
  * ``backend="spec"`` — the pure-jnp radix-2 semantic specification
    (models/), for debugging and cross-checking.
  * ``backend="auto"`` — :func:`_resolve_backend` picks one of the above.

Every transform is plain JAX, so ``jax.grad`` / ``jax.vjp`` differentiate
all of them with JAX's own rules.

Normalization follows numpy: ``ifft`` divides by N, ``irfft`` by N, unless
``norm=None`` which gives the reference's raw unnormalized transforms
(the reference never normalizes an inverse; SURVEY.md quirk 3).
"""

from __future__ import annotations

from typing import Literal

import jax
import jax.numpy as jnp

from smfft import params as P
from smfft.models import cooley_tukey, real as real_model
from smfft.ops import matmul_fft

Backend = Literal["auto", "jnp", "xla", "spec"]
BACKENDS: tuple[str, ...] = ("auto", "jnp", "xla", "spec")


# Huge-N inputs with fewer elements than this take the four-step over
# matmul rows on a GPU; from here up, jnp.fft at full length.
HUGE_JNP_MIN_ELEMS = 1 << 20


def _resolve_backend(backend: str, ordered: bool = True,
                     huge_elems: int | None = None) -> str:
    """The one rule that picks an engine by platform.

    On a GPU, ``auto`` takes the ``jnp.fft`` route (cuFFT) for every
    natural-order transform: on the H100 it was faster than the matmul
    engine at every supported row size, forward and inverse, C2C and
    real.  For huge N (``huge_elems``: the input's element count) it
    takes ``jnp.fft`` at full length from HUGE_JNP_MIN_ELEMS elements up,
    where it beat the four-step (1.2-6x from 2**21 to 2**27 at batch 1),
    and the four-step over matmul rows below, where each call is tens of
    microseconds and the four-step's was the shorter (PERF.md, "Bring-up
    findings").  The digit-reversed ``ordered=False`` layout exists only
    in the matmul engine, and the CPU keeps the matmul engine too.
    """
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; choose one of {BACKENDS} "
            f"(the 'pallas' kernels were removed)")
    if backend != "auto":
        if backend == "jnp" and not ordered:
            raise ValueError(
                "backend='jnp' has natural-order layouts only; the "
                "ordered=False layout is the matmul engine's "
                "(backend='xla' or 'auto')")
        return backend
    if not ordered or jax.default_backend() != "gpu":
        return "xla"
    if huge_elems is not None and huge_elems < HUGE_JNP_MIN_ELEMS:
        return "xla"
    return "jnp"


_warned_precisions: set[str] = set()

#: Precision tiers.  They steer the matmul engine's fp32 matrix products
#: (``backend="xla"``, and every ``ordered=False`` transform); the
#: ``jnp.fft`` route computes in fp32 whatever the tier.
#:   "highest" — fp32 products (``lax.Precision.HIGHEST``); the default.
#:   "exact"   — the same products as "highest" on this engine.
#:   "high"    — the same products as "highest"; its contract is the
#:               reference's 1e-4 verification gate (FFT.c:12).
#:   "fast"    — ``lax.Precision.HIGH`` products.
#:   "default" — ``lax.Precision.DEFAULT`` products: TF32 on an NVIDIA
#:               GPU, outside the 1e-4 gate.  Requesting it warns.
#: Errors of every tier on the H100 are in PERF.md ("Bring-up findings").
PRECISIONS: tuple[str, ...] = tuple(matmul_fft.PRECISIONS)


def _resolve_precision(precision: str | None) -> str:
    """None -> the process-level default (config.flags.precision, the
    SMFFT_PRECISION analogue of the reference's debug.h compile flags)."""
    if precision is None:
        from smfft.config import flags
        precision = flags.precision
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; choose one of "
                         f"{PRECISIONS}")
    if precision == "default" and precision not in _warned_precisions:
        import warnings
        _warned_precisions.add(precision)
        warnings.warn(
            "precision='default' lets the matmul engine run its fp32 "
            "products at the platform's default precision (TF32 on an "
            "NVIDIA GPU), outside the reference's 1e-4 gate.  Use "
            "'highest' for fp32 accuracy.", UserWarning, stacklevel=3)
    return precision


def _check_c2c(n: int):
    if n not in P.SUPPORTED_C2C_SIZES:
        raise ValueError(
            f"Error wrong FFT length! N={n}; supported: {P.SUPPORTED_C2C_SIZES}")


# ---------------------------------------------------------------------------
# The jnp.fft route.  XLA already divides every inverse by N in a pass of
# its own, so the route asks jnp.fft for the normalization it wants
# instead of undoing and redoing it.
# ---------------------------------------------------------------------------


def _jnp_c2c(x: jnp.ndarray, inverse: bool, norm_div: bool) -> jnp.ndarray:
    x = jnp.asarray(x).astype(jnp.complex64)
    if not inverse:
        return jnp.fft.fft(x)
    return jnp.fft.ifft(x, norm="backward" if norm_div else "forward")


def _jnp_rfft(x: jnp.ndarray, packed: bool) -> jnp.ndarray:
    spec = jnp.fft.rfft(jnp.asarray(x, jnp.float32))
    return real_model.numpy_to_packed_layout(spec) if packed else spec


def _jnp_irfft(x: jnp.ndarray, n: int, packed: bool,
               norm_div: bool) -> jnp.ndarray:
    if packed:
        x = real_model.packed_to_numpy_layout(x)
    out = jnp.fft.irfft(x, n)
    # the raw contract is (N/2)-scaled (SMFFT_Stockham_R2C_C2R/FFT.c:170)
    return out if norm_div else out * (n // 2)


# ---------------------------------------------------------------------------
# Row transforms, N <= 16384
# ---------------------------------------------------------------------------


def _c2c(x: jnp.ndarray, inverse: bool, ordered: bool, backend: str,
         precision: str | None, norm_div: bool = False) -> jnp.ndarray:
    """C2C row transform; ``norm_div`` divides an inverse by N."""
    n = x.shape[-1]
    _check_c2c(n)
    precision = _resolve_precision(precision)
    backend = _resolve_backend(backend, ordered)
    if backend == "jnp":
        return _jnp_c2c(x, inverse, norm_div)
    # resolve the static plan once — the L0 dispatch spine (the
    # reference's 32-case template switch, FFT-GPU-32bit.cu:599-659)
    plan = P.plan_for(n, "inverse" if inverse else "forward", "c2c", ordered)
    if backend == "spec":
        out = cooley_tukey.fft_dit(x, inverse=inverse, ordered=plan.ordered)
    else:
        out = matmul_fft.fft_matmul(x, inverse=inverse, ordered=plan.ordered,
                                    radices=plan.radices,
                                    precision=precision)
    return out / n if norm_div else out


def fft(x: jnp.ndarray, ordered: bool = True, backend: Backend = "auto",
        precision: str | None = None) -> jnp.ndarray:
    """Batched forward C2C FFT over the last axis.

    Args:
      x: complex64 (..., N), N in {32..16384} powers of two.
      ordered: natural-order output (reference ``fft_reorder=1``); False
        returns the matmul engine's digit-reversed output
        (``fft_reorder=0``), which :func:`ifft_unordered` consumes.
      backend: "auto" | "jnp" | "xla" | "spec".
      precision: "highest" (default) | "exact" | "high" | "fast" |
        "default"; see the tier notes above :func:`_resolve_precision`.
    """
    return _c2c(x, inverse=False, ordered=ordered, backend=backend,
                precision=precision)


def ifft(x: jnp.ndarray, ordered: bool = True, backend: Backend = "auto",
         precision: str | None = None, norm: str | None = "backward") -> jnp.ndarray:
    """Batched inverse C2C FFT. ``norm="backward"`` divides by N (numpy
    semantics); ``norm=None`` matches the reference's unnormalized inverse."""
    return _c2c(x, inverse=True, ordered=ordered, backend=backend,
                precision=precision, norm_div=norm == "backward")


def ifft_unordered(x: jnp.ndarray, backend: Backend = "auto",
                   precision: str | None = None,
                   norm: str | None = "backward") -> jnp.ndarray:
    """Inverse C2C FFT consuming the digit-reversed layout that
    ``fft(ordered=False)`` produces, returning natural order — the
    convolution-roundtrip pair (the reference's fft_reorder=0 use case,
    README.md:30-33).

    Each backend consumes the unordered layout its own forward produces
    (xla: the factorization's digit reversal; spec: bit reversal), so
    fft(ordered=False) |> ifft_unordered round-trips on either.
    """
    n = x.shape[-1]
    _check_c2c(n)
    precision = _resolve_precision(precision)
    backend = _resolve_backend(backend, ordered=False)
    if backend == "spec":
        perm = cooley_tukey.bit_reverse_indices(n)
        out = cooley_tukey.fft_dit(x[..., perm], inverse=True)
    else:
        perm = matmul_fft.digit_reverse_indices(n, P.get_factorization(n))
        out = matmul_fft.fft_matmul(x[..., perm], inverse=True,
                                    precision=precision)
    if norm == "backward":
        out = out / n
    return out


def _apply_response(spec: jnp.ndarray, h: jnp.ndarray, bank: bool,
                    signal_ndim: int) -> jnp.ndarray:
    """spec * h, or with an (M, bins) bank: (M, ...) = spec[None] * h_m."""
    if bank:
        return spec[None] * h.reshape((h.shape[0],) + (1,) * (signal_ndim - 1)
                                      + (h.shape[-1],))
    return spec * h


def convolve(x: jnp.ndarray, h: jnp.ndarray, backend: Backend = "auto",
             precision: str | None = None) -> jnp.ndarray:
    """Batched circular convolution via the spectral theorem:
    ``ifft(fft(x) * h)``.

    Args:
      x: complex64 (..., N) signal batch, N a supported C2C size.
      h: complex64 (N,) filter FREQUENCY response in natural order
        (compute once with ``fft(h_time)``) — or an (M, N) bank of
        responses, returning (M, ..., N): every signal convolved with
        every template (the matched-filtering shape; the forward FFT of
        each signal is computed once for the whole bank).
      backend / precision: as :func:`fft`.
    """
    n = x.shape[-1]
    _check_c2c(n)
    bank = h.ndim == 2
    if h.shape != (n,) and not (bank and h.shape[-1] == n):
        raise ValueError(f"filter must be natural-order frequency response "
                         f"of shape ({n},) or (M, {n}), got {h.shape}")
    spec = fft(x, backend=backend, precision=precision)
    return ifft(_apply_response(spec, h, bank, x.ndim), backend=backend,
                precision=precision)


def convolve_real(x: jnp.ndarray, h: jnp.ndarray,
                  backend: Backend = "auto",
                  precision: str | None = None) -> jnp.ndarray:
    """Batched REAL circular convolution: real signals against a real
    filter's rfft-style response, at half the traffic of :func:`convolve`.

    Args:
      x: float32 (..., N) real signal batch, N >= 256 a supported real
        size.
      h: complex64 (N/2+1,) filter frequency response in natural order
        (compute once with ``rfft(h_time)``) — or an (M, N/2+1) bank of
        responses, returning (M, ..., N) with each signal's r2c computed
        once for the whole bank.
    """
    n = x.shape[-1]
    if n not in P.SUPPORTED_REAL_SIZES or n < 256:
        raise ValueError(
            f"Error wrong FFT length! N={n}; real convolve supports "
            f"{[s for s in P.SUPPORTED_REAL_SIZES if s >= 256]}")
    bank = h.ndim == 2
    if h.shape != (n // 2 + 1,) and not (bank and h.shape[-1] == n // 2 + 1):
        raise ValueError(f"filter must be an rfft-style frequency response "
                         f"of shape ({n // 2 + 1},) or (M, {n // 2 + 1}), "
                         f"got {h.shape}")
    spec = rfft(x, backend=backend, precision=precision)
    return irfft(_apply_response(spec, h, bank, x.ndim), n=n,
                 backend=backend, precision=precision)


# ---------------------------------------------------------------------------
# Huge N (beyond the 16384 row cap)
# ---------------------------------------------------------------------------


def fft_large(x: jnp.ndarray, backend: Backend = "auto",
              precision: str | None = None) -> jnp.ndarray:
    """Forward C2C FFT for huge power-of-two N (2**15..2**28), batched
    over leading axes — sizes beyond the row cap (the reference stops at
    4096, FFT-GPU-32bit.cu:656-658).  The ``jnp`` backend transforms the
    full length at once; ``xla`` runs the four-step decomposition
    (ops/fourstep.py) over matmul-engine rows.  Sizes <= 16384 route to
    :func:`fft`."""
    return _large_c2c(x, False, backend, precision, False)


def ifft_large(x: jnp.ndarray, backend: Backend = "auto",
               precision: str | None = None,
               norm: str | None = "backward") -> jnp.ndarray:
    """Inverse of :func:`fft_large`.  ``norm="backward"`` divides by N
    (numpy); ``norm=None`` is the reference's raw unnormalized inverse."""
    if norm not in ("backward", None):
        raise ValueError(
            f"ifft_large supports norm='backward' (numpy) or norm=None "
            f"(raw reference scale); got {norm!r}")
    return _large_c2c(x, True, backend, precision, norm == "backward")


def _large_c2c(x, inverse, backend, precision, norm_div):
    from smfft.ops import fourstep
    n = x.shape[-1]
    if n in P.SUPPORTED_C2C_SIZES:
        return (ifft(x, backend=backend, precision=precision,
                     norm="backward" if norm_div else None)
                if inverse else fft(x, backend=backend, precision=precision))
    fourstep.split_factors(n)   # the reference-style size error
    precision = _resolve_precision(precision)
    backend = _resolve_backend(backend, huge_elems=x.size)
    if backend == "jnp":
        return _jnp_c2c(x, inverse, norm_div)
    out = fourstep.fft_four_step(x, inverse=inverse, backend=backend,
                                 precision=precision)
    return out / n if norm_div else out


def rfft_large(x: jnp.ndarray, backend: Backend = "auto",
               precision: str | None = None,
               packed: bool = False) -> jnp.ndarray:
    """R2C FFT for huge power-of-two N (2**15..2**29).  The ``xla``
    backend runs the reference's half-size pack trick
    (SMFFT_Stockham_R2C_C2R/FFT-GPU-32bit-Stockham.cu:269-344) at
    four-step scale (ops/fourstep.py).  Sizes <= 16384 route to
    :func:`rfft` / :func:`fft_packed_real`."""
    from smfft.ops import fourstep
    n = x.shape[-1]
    if n in P.SUPPORTED_REAL_SIZES:
        if packed:
            return fft_packed_real(x, backend=backend, precision=precision)
        return rfft(x, backend=backend, precision=precision)
    fourstep._check_real_n(n)
    precision = _resolve_precision(precision)
    backend = _resolve_backend(backend, huge_elems=x.size)
    if backend == "jnp":
        return _jnp_rfft(x, packed)
    return fourstep.rfft_four_step(x, packed=packed, backend=backend,
                                   precision=precision)


def irfft_large(x: jnp.ndarray, n: int | None = None,
                backend: Backend = "auto", precision: str | None = None,
                norm: str | None = "backward",
                packed: bool = False) -> jnp.ndarray:
    """Inverse of :func:`rfft_large`.  ``norm="backward"`` returns the
    signal (numpy); ``norm=None`` keeps the reference's raw (N/2)-scaled
    output (SMFFT_Stockham_R2C_C2R/FFT.c:170-171)."""
    from smfft.ops import fourstep
    if norm not in ("backward", None):
        raise ValueError(
            f"irfft_large supports norm='backward' (numpy) or norm=None "
            f"(raw reference scale); got {norm!r}")
    if n is None:
        n = (x.shape[-1] - 1) * 2 if not packed else x.shape[-1] * 2
    if n in P.SUPPORTED_REAL_SIZES:
        return irfft(x, n=n, backend=backend, precision=precision,
                     norm=norm, packed=packed)
    fourstep._check_real_n(n)
    precision = _resolve_precision(precision)
    backend = _resolve_backend(backend, huge_elems=x.size)
    if backend == "jnp":
        return _jnp_irfft(x, n, packed, norm == "backward")
    return fourstep.irfft_four_step(x, n, packed=packed, backend=backend,
                                    precision=precision,
                                    normalize=norm == "backward")


# ---------------------------------------------------------------------------
# Real row transforms
# ---------------------------------------------------------------------------


def _rfft_impl(x: jnp.ndarray, backend: str, precision: str | None,
               packed: bool) -> jnp.ndarray:
    n = x.shape[-1]
    if n not in P.SUPPORTED_REAL_SIZES:
        raise ValueError(
            f"Error wrong FFT length! N={n}; supported: {P.SUPPORTED_REAL_SIZES}")
    precision = _resolve_precision(precision)
    backend = _resolve_backend(backend)
    if backend == "jnp":
        return _jnp_rfft(x, packed)
    if backend == "spec":
        return real_model.rfft_spec(x, packed=packed)
    z = real_model.pack_real(x)
    zf = matmul_fft.fft_matmul(z, precision=precision)
    return real_model._split_forward(zf, n, packed=packed)


def rfft(x: jnp.ndarray, backend: Backend = "auto",
         precision: str | None = None) -> jnp.ndarray:
    """Batched R2C FFT: real (..., N) -> complex (..., N/2+1), numpy
    layout."""
    return _rfft_impl(x, backend, precision, False)


def fft_packed_real(x: jnp.ndarray, backend: Backend = "auto",
                    precision: str | None = None) -> jnp.ndarray:
    """R2C in the reference's packed layout: (..., N/2) complex with
    out[..., 0] = DC + 1j*Nyquist (FFT-GPU-32bit-Stockham.cu:332-340)."""
    return _rfft_impl(x, backend, precision, True)


def irfft(x: jnp.ndarray, n: int | None = None, backend: Backend = "auto",
          precision: str | None = None, norm: str | None = "backward",
          packed: bool = False) -> jnp.ndarray:
    """Batched C2R inverse FFT: complex spectrum -> real (..., N).

    ``norm="backward"`` divides by N (numpy); ``norm=None`` returns the
    reference's raw (N/2)-scaled output
    (SMFFT_Stockham_R2C_C2R/FFT.c:170-171).  ``packed=True`` consumes
    the :func:`fft_packed_real` layout."""
    if n is None:
        n = (x.shape[-1] - 1) * 2 if not packed else x.shape[-1] * 2
    if n not in P.SUPPORTED_REAL_SIZES:
        raise ValueError(f"Error wrong FFT length! N={n}")
    norm_div = norm == "backward"
    precision = _resolve_precision(precision)
    backend = _resolve_backend(backend)
    if backend == "jnp":
        return _jnp_irfft(x, n, packed, norm_div)
    if backend == "spec":
        out = real_model.irfft_spec(x, n, packed=packed, normalize=False)
    else:
        z = real_model._merge_inverse(x, n, packed=packed)
        zi = matmul_fft.fft_matmul(z, inverse=True, precision=precision)
        out = jnp.stack([jnp.real(zi), jnp.imag(zi)], axis=-1).reshape(
            x.shape[:-1] + (n,))
    if norm_div:
        # the raw half-size-inverse output is (N/2)-scaled, so this yields x
        out = out / (n // 2)
    return out
