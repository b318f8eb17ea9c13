"""N-dimensional transforms and numpy-compatible spectral helpers.

The reference is strictly 1-D batched (one FFT per CUDA block,
SMFFT_CooleyTukey_C2C/FFT-GPU-32bit.cu:534-551); its home pipelines
(Astro-Accelerate imaging/periodicity) compose 2-D transforms out of
batched 1-D passes on the host.  Here that composition is a first-class
API: an N-D transform is a sequence of batched 1-D passes over the last
axis with XLA transposes between them, so a 2-D FFT costs two batched
1-D transforms plus one relayout each way.

Every axis length must be a supported 1-D size (the same static
"Error wrong FFT length!" contract as the 1-D API).  Layouts and
normalization follow numpy.fft exactly (rfft2/irfft2 transform the last
axis with the real kernel and the remaining axes with C2C).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from smfft import api


def _norm_axes(ndim: int, axes) -> tuple[int, ...]:
    if axes is None:
        axes = tuple(range(ndim))
    elif isinstance(axes, int):
        axes = (axes,)
    out = tuple(a % ndim for a in axes)
    if len(set(out)) != len(out):
        raise ValueError(f"repeated axis in axes={axes}")
    return out


def _apply_last(x, ax: int, fn):
    """Move axis ``ax`` last, apply ``fn``, move back (no-op moves when
    ``ax`` already is the last axis)."""
    nd = x.ndim
    if ax == nd - 1:
        return fn(x)
    return jnp.swapaxes(fn(jnp.swapaxes(x, ax, nd - 1)), ax, nd - 1)


def fftn(x: jnp.ndarray, axes=None, ordered: bool = True,
         backend: api.Backend = "auto",
         precision: str | None = None) -> jnp.ndarray:
    """N-D forward C2C FFT over ``axes`` (default: all axes), numpy
    ``fftn`` semantics.  Every transformed axis length must be a
    supported 1-D size.  ``ordered=False`` is only meaningful for a
    single transform axis (later passes need natural-order input)."""
    axes = _norm_axes(x.ndim, axes)
    if not ordered and len(axes) > 1:
        raise ValueError("ordered=False requires a single transform axis")
    for ax in axes:
        x = _apply_last(x, ax, lambda v: api.fft(
            v, ordered=ordered, backend=backend, precision=precision))
    return x


def ifftn(x: jnp.ndarray, axes=None, backend: api.Backend = "auto",
          precision: str | None = None,
          norm: str | None = "backward") -> jnp.ndarray:
    """N-D inverse C2C FFT over ``axes`` (numpy ``ifftn``: each axis
    divides by its length under ``norm="backward"``)."""
    axes = _norm_axes(x.ndim, axes)
    for ax in axes:
        x = _apply_last(x, ax, lambda v: api.ifft(
            v, backend=backend, precision=precision, norm=norm))
    return x


def fft2(x: jnp.ndarray, axes=(-2, -1), ordered: bool = True,
         backend: api.Backend = "auto",
         precision: str | None = None) -> jnp.ndarray:
    """2-D forward C2C FFT (numpy ``fft2``)."""
    return fftn(x, axes=axes, ordered=ordered, backend=backend,
                precision=precision)


def ifft2(x: jnp.ndarray, axes=(-2, -1), backend: api.Backend = "auto",
          precision: str | None = None,
          norm: str | None = "backward") -> jnp.ndarray:
    """2-D inverse C2C FFT (numpy ``ifft2``)."""
    return ifftn(x, axes=axes, backend=backend, precision=precision,
                 norm=norm)


def _check_real_last_axis(ndim: int, axes, fname: str):
    if axes[-1] != ndim - 1:
        raise ValueError(f"{fname} requires the last transform axis to "
                         f"be the last array axis (numpy applies the "
                         f"real transform there)")


def rfft2(x: jnp.ndarray, axes=(-2, -1), backend: api.Backend = "auto",
          precision: str | None = None) -> jnp.ndarray:
    """2-D R2C FFT (numpy ``rfft2``): real kernel over ``axes[-1]``
    (half-spectrum output), C2C over the remaining axes."""
    axes = _norm_axes(x.ndim, axes)
    _check_real_last_axis(x.ndim, axes, "rfft2")
    x = api.rfft(x, backend=backend, precision=precision)
    for ax in axes[:-1]:
        x = _apply_last(x, ax, lambda v: api.fft(
            v, backend=backend, precision=precision))
    return x


def rfftn(x: jnp.ndarray, axes=None, backend: api.Backend = "auto",
          precision: str | None = None) -> jnp.ndarray:
    """N-D R2C FFT (numpy ``rfftn``): real kernel over the last given
    axis (half-spectrum output), C2C over the rest.  Default: all axes.
    The last transform axis must be the last array axis (where numpy
    applies the real transform)."""
    axes = _norm_axes(x.ndim, axes)
    _check_real_last_axis(x.ndim, axes, "rfftn")
    return rfft2(x, axes=axes, backend=backend, precision=precision)


def irfftn(x: jnp.ndarray, n: int | None = None, axes=None,
           backend: api.Backend = "auto", precision: str | None = None,
           norm: str | None = "backward") -> jnp.ndarray:
    """N-D C2R inverse FFT (numpy ``irfftn``), inverse of
    :func:`rfftn`."""
    axes = _norm_axes(x.ndim, axes)
    _check_real_last_axis(x.ndim, axes, "irfftn")
    return irfft2(x, n=n, axes=axes, backend=backend,
                  precision=precision, norm=norm)


def _fit_last(x: jnp.ndarray, m: int) -> jnp.ndarray:
    """numpy's n-parameter semantics: zero-pad or truncate the last axis
    to length m before transforming."""
    k = x.shape[-1]
    if k == m:
        return x
    if k > m:
        return x[..., :m]
    pad = [(0, 0)] * (x.ndim - 1) + [(0, m - k)]
    return jnp.pad(x, pad)


def _norm_scale(norm: str | None, n: int, forward: bool) -> float:
    """numpy norm conventions as a scalar factor on top of an
    UNNORMALIZED transform of length n (forward=True for the
    forward-like direction: fft/hfft; False for ifft/ihfft)."""
    if norm in (None, "backward"):
        return 1.0 if forward else 1.0 / n
    if norm == "ortho":
        return 1.0 / float(np.sqrt(n))
    if norm == "forward":
        return 1.0 / n if forward else 1.0
    raise ValueError(f"invalid norm value {norm!r}; expected None, "
                     f"'backward', 'ortho' or 'forward'")


def hfft(x: jnp.ndarray, n: int | None = None, norm: str | None = None,
         backend: api.Backend = "auto",
         precision: str | None = None) -> jnp.ndarray:
    """FFT of a Hermitian-symmetric signal given by its half-spectrum
    (numpy ``hfft``): real (..., n) output from complex (..., n/2+1)
    input.  Rides the C2R transform via hfft(x) = N * irfft(conj(x))
    (the two are adjoint up to conjugation).  ``n`` pads/truncates the
    half-spectrum input to n/2+1 points; ``norm`` follows numpy
    ("backward"/"ortho"/"forward")."""
    if n is None:
        n = (x.shape[-1] - 1) * 2
    scale = _norm_scale(norm, n, forward=True)
    x = _fit_last(x, n // 2 + 1)
    out = api.irfft(jnp.conj(x), n=n, backend=backend,
                    precision=precision, norm=None)
    return out * np.float32(2.0 * scale)   # raw irfft is (N/2)-scaled


def ihfft(x: jnp.ndarray, n: int | None = None, norm: str | None = None,
          backend: api.Backend = "auto",
          precision: str | None = None) -> jnp.ndarray:
    """Inverse of :func:`hfft` (numpy ``ihfft``): complex half-spectrum
    (..., n/2+1) from real (..., n) input = conj(rfft(x)) / n.  ``n``
    pads/truncates the real input (numpy semantics); ``norm`` follows
    numpy ("backward"/"ortho"/"forward")."""
    if n is None:
        n = x.shape[-1]
    scale = _norm_scale(norm, n, forward=False)
    x = _fit_last(x, n)
    return jnp.conj(api.rfft(x, backend=backend,
                             precision=precision)) * np.float32(scale)


def irfft2(x: jnp.ndarray, n: int | None = None, axes=(-2, -1),
           backend: api.Backend = "auto", precision: str | None = None,
           norm: str | None = "backward") -> jnp.ndarray:
    """2-D C2R inverse FFT (numpy ``irfft2``): inverse C2C over the
    leading transform axes, real inverse over the last."""
    axes = _norm_axes(x.ndim, axes)
    if axes[-1] != x.ndim - 1:
        raise ValueError("irfft2 requires the last transform axis to be "
                         "the last array axis")
    for ax in axes[:-1]:
        x = _apply_last(x, ax, lambda v: api.ifft(
            v, backend=backend, precision=precision, norm=norm))
    return api.irfft(x, n=n, backend=backend, precision=precision,
                     norm=norm)


# ---------------------------------------------------------------------------
# numpy-compatible spectral helpers (host-computable, trivially jittable)
# ---------------------------------------------------------------------------


def fftshift(x: jnp.ndarray, axes=None) -> jnp.ndarray:
    """numpy ``fftshift``: move the zero-frequency bin to the center."""
    axes = _norm_axes(x.ndim, axes)
    return jnp.fft.fftshift(x, axes=axes)


def ifftshift(x: jnp.ndarray, axes=None) -> jnp.ndarray:
    """numpy ``ifftshift``: undo :func:`fftshift`."""
    axes = _norm_axes(x.ndim, axes)
    return jnp.fft.ifftshift(x, axes=axes)


def fftfreq(n: int, d: float = 1.0) -> jnp.ndarray:
    """numpy ``fftfreq`` as fp32 (bin center frequencies)."""
    return jnp.asarray(np.fft.fftfreq(n, d).astype(np.float32))


def rfftfreq(n: int, d: float = 1.0) -> jnp.ndarray:
    """numpy ``rfftfreq`` as fp32 (one-sided bin frequencies)."""
    return jnp.asarray(np.fft.rfftfreq(n, d).astype(np.float32))
