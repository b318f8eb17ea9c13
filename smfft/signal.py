"""Linear (streaming) convolution on top of the batched circular convolution.

The reference library's home pipeline exists to filter LONG sampled
streams with short kernels (reference README.md:10 — "convolution via
shared-memory FFTs"); the circular transforms are the building block,
overlap-save is the standard framing that turns them into linear
convolution.  This module is that framing: the stream is framed into a
BATCH of overlapping rows (one XLA gather), the whole batch runs through
ONE batched convolution (FFT -> multiply -> iFFT, api.convolve), and the
valid regions are stitched back (one reshape + slice).

``fftconvolve(x, h)`` matches ``numpy.convolve(x, h)`` ("full" mode)
/ scipy.signal.fftconvolve semantics for 1-D signals and batches.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from smfft import params as P


def _pick_nfft(k: int) -> int:
    """Smallest supported FFT size with hop >= 3/4 n (so the per-frame
    K-1 overlap re-read stays under a third of the stream traffic)."""
    for n in P.SUPPORTED_C2C_SIZES:
        if n >= 256 and n - k + 1 >= (3 * n) // 4:
            return n
    raise ValueError(
        f"filter too long for overlap-save: K={k} needs 4*(K-1) <= "
        f"{P.SUPPORTED_C2C_SIZES[-1]}")


def fftconvolve(x: jnp.ndarray, h: jnp.ndarray, mode: str = "full",
                n_fft: int | None = None, backend: str = "auto",
                precision: str | None = None) -> jnp.ndarray:
    """Linear convolution of (batched) signals with a short filter via
    overlap-save over the batched circular convolution.

    Args:
      x: (T,) or (B, T) signal(s) — float32 for the real path (half the
        traffic), complex64 for the complex path.
      h: (K,) time-domain filter taps (real for the real path).
      mode: "full" (T+K-1 outputs, numpy.convolve default), "same"
        (T, centered) or "valid" (T-K+1).
      n_fft: FFT frame length override; default picks the smallest
        supported size with at least 3/4 useful hop.
      backend / precision: forwarded to :func:`smfft.api.convolve`.

    All frames run as one batched convolution; the framing gather and the output stitch are one XLA op each.
    """
    from smfft import api

    if mode not in ("full", "same", "valid"):
        raise ValueError(f"mode must be full|same|valid, got {mode!r}")
    k = int(h.shape[-1])
    if h.ndim != 1:
        raise ValueError(f"filter must be 1-D taps, got shape {h.shape}")
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    if x.ndim != 2:
        raise ValueError(f"signal must be (T,) or (B, T), got {x.shape}")
    b, t = x.shape
    n = n_fft or _pick_nfft(k)
    if n not in P.SUPPORTED_C2C_SIZES or n < 256 or k >= n:
        raise ValueError(f"n_fft={n} unsupported or not longer than the "
                         f"filter (K={k})")
    hop = n - k + 1
    full_len = t + k - 1
    frames = -(-full_len // hop)

    real = (not jnp.iscomplexobj(x)) and (not jnp.iscomplexobj(h))
    # overlap-save: frame f covers padded positions [f*hop, f*hop + n);
    # left-pad K-1 (linear-conv warmup), right-pad to the frame grid
    pad_r = (frames - 1) * hop + n - (k - 1) - t
    dt = x.dtype if real else jnp.complex64
    xp = jnp.concatenate(
        [jnp.zeros((b, k - 1), dt), x.astype(dt),
         jnp.zeros((b, max(0, pad_r)), dt)], axis=-1)
    idx = (np.arange(frames)[:, None] * hop
           + np.arange(n)[None, :])               # (F, n) static indices
    fx = xp[:, idx]                               # (B, F, n) one gather
    fx = fx.reshape(b * frames, n)

    if real:
        hf = api.rfft(_pad_taps(h, n, real=True),
                      backend=backend, precision=precision)[0]
        y = api.convolve_real(fx, hf, backend=backend, precision=precision)
    else:
        hf = api.fft(_pad_taps(h, n, real=False), backend=backend,
                     precision=precision)[0]
        y = api.convolve(fx, hf, backend=backend, precision=precision)
    # per-frame valid region: circular positions [K-1, n) are the linear
    # convolution outputs for stream positions f*hop .. f*hop + hop - 1
    y = y.reshape(b, frames, n)[:, :, k - 1:]     # (B, F, hop)
    y = y.reshape(b, frames * hop)[:, :full_len]
    if mode == "same":
        start = (k - 1) // 2
        y = y[:, start:start + t]
    elif mode == "valid":
        y = y[:, k - 1:t]
    return y[0] if squeeze else y


def _pad_taps(h: jnp.ndarray, n: int, real: bool) -> jnp.ndarray:
    if real:
        return jnp.concatenate(
            [h.astype(jnp.float32),
             jnp.zeros((n - h.shape[-1],), jnp.float32)])[None, :]
    hc = jnp.asarray(h).astype(jnp.complex64)
    return jnp.concatenate(
        [hc, jnp.zeros((n - h.shape[-1],), jnp.complex64)])[None, :]


#: scipy.signal.fftconvolve and scipy.signal.oaconvolve agree for 1-D
#: inputs; the overlap-save framing above covers both names.
oaconvolve = fftconvolve


def fftcorrelate(x: jnp.ndarray, h: jnp.ndarray, mode: str = "full",
                 n_fft: int | None = None, backend: str = "auto",
                 precision: str | None = None) -> jnp.ndarray:
    """Linear cross-correlation (scipy.signal.correlate semantics,
    ``method="fft"``): ``correlate(x, h) = convolve(x, conj(h[::-1]))``
    — rides the same overlap-save framing as :func:`fftconvolve`.

    ``mode="same"`` matches scipy (centered on the x grid); "valid"
    requires ``len(x) >= len(h)``.
    """
    hr = jnp.conj(h[..., ::-1]) if jnp.iscomplexobj(h) else h[..., ::-1]
    y = fftconvolve(x, hr, mode="full", n_fft=n_fft, backend=backend,
                    precision=precision)
    k = int(h.shape[-1])
    t = x.shape[-1]
    if mode == "full":
        return y
    if mode == "same":
        start = (k - 1) // 2
        return y[..., start:start + t]
    if mode == "valid":
        return y[..., k - 1:t]
    raise ValueError(f"mode must be full|same|valid, got {mode!r}")


def hilbert(x: jnp.ndarray, backend: str = "auto",
            precision: str | None = None) -> jnp.ndarray:
    """Analytic signal of real rows (scipy.signal.hilbert): complex
    (..., n) whose real part is ``x`` and imaginary part its Hilbert
    transform.

    The one-sided spectral mask [1, 2, ..., 2, 1, 0, ..., 0] is a
    frequency response, so the whole transform is one FFT -> mask ->
    iFFT convolution (:func:`smfft.api.convolve`) — the composition the
    reference builds from its ``__device__`` cores (reference
    README.md:10,30-33).
    """
    from smfft import api

    n = x.shape[-1]
    if n not in P.SUPPORTED_C2C_SIZES:
        raise ValueError(f"Error wrong FFT length! N={n}; supported: "
                         f"{P.SUPPORTED_C2C_SIZES}")
    if jnp.iscomplexobj(x):
        raise ValueError("hilbert expects real input rows")
    mask = np.zeros(n, np.float32)
    mask[0] = 1.0
    mask[1:n // 2] = 2.0
    mask[n // 2] = 1.0
    h = jax.lax.complex(jnp.asarray(mask), jnp.zeros((n,), jnp.float32))
    return api.convolve(jnp.asarray(x).astype(jnp.complex64), h,
                        backend=backend,
                        precision=precision)


def envelope(x: jnp.ndarray, backend: str = "auto",
             precision: str | None = None) -> jnp.ndarray:
    """Amplitude envelope ``|hilbert(x)|`` of real rows (fp32)."""
    return jnp.abs(hilbert(x, backend=backend, precision=precision))


def resample(x: jnp.ndarray, num: int, axis: int = -1,
             backend: str = "auto",
             precision: str | None = None) -> jnp.ndarray:
    """Fourier-domain resampling (scipy.signal.resample) of real or
    complex rows from n to ``num`` samples along ``axis``.

    Both lengths may be ANY size 1..8192 — supported powers of two ride
    the row transforms directly, everything else the Bluestein path
    (:func:`smfft.bluestein.fft_any`).  scipy's band-limited
    interpolation semantics: truncate or zero-pad the centered spectrum,
    halve the split Nyquist bin, scale by num/n.
    """
    from smfft.bluestein import fft_any, ifft_any

    if axis != -1 and axis != x.ndim - 1:
        x = jnp.swapaxes(x, axis, -1)
    n = x.shape[-1]
    was_real = not jnp.iscomplexobj(x)
    spec = fft_any(jnp.asarray(x).astype(jnp.complex64), backend=backend, precision=precision)
    m = min(n, num)
    m2 = m // 2 + 1
    # centered spectrum surgery as one (num,) gather + scale mask
    # (host-built, exactly scipy's two-sided path): out bin k takes in
    # bin src[k] scaled by w[k]
    src = np.zeros(num, np.int64)
    w = np.zeros(num, np.float32)
    src[:m2] = np.arange(m2)
    w[:m2] = 1.0
    if m2 < m:                           # negative-frequency block
        src[num - (m - m2):] = np.arange(n - (m - m2), n)
        w[num - (m - m2):] = 1.0
    fold = m % 2 == 0 and num < n       # unpaired bin at m//2
    if m % 2 == 0 and n < num:          # upsample: split the bin
        w[m // 2] = 0.5
        src[num - m // 2] = m // 2
        w[num - m // 2] = 0.5
    out = spec[..., jnp.asarray(src)] * jnp.asarray(w)
    if fold:
        # downsample: unite the +/- pair into the new Nyquist bin
        out = out.at[..., m // 2].add(spec[..., n - m // 2])
    y = ifft_any(out, backend=backend, precision=precision,
                 norm=None) * np.float32(1.0 / n)
    y = jnp.real(y) if was_real else y
    if axis != -1 and axis != x.ndim - 1:
        y = jnp.swapaxes(y, axis, -1)
    return y


# ---------------------------------------------------------------------------
# Spectral analysis: windows, power spectra, periodogram / Welch / STFT /
# spectrogram.  The downstream shape of the reference's home pipeline
# (Astro-Accelerate periodicity search) is |X_k|^2 of windowed frames:
# an rfft with the window multiply fused into the XLA framing gather and
# the square into the pass after it.
# ---------------------------------------------------------------------------


def get_window(window, n: int, periodic: bool = True) -> jnp.ndarray:
    """Window vector of length ``n`` (fp32).

    ``window``: "boxcar" | "hann" | "hamming" | "blackman" | "bartlett"
    or a ("kaiser", beta) tuple; an array of shape (n,) passes through.
    ``periodic=True`` gives the DFT-even form used for spectral
    estimation (scipy's fftbins=True).
    """
    if isinstance(window, (jnp.ndarray, np.ndarray)):
        w = np.asarray(window, np.float32)
        if w.shape != (n,):
            raise ValueError(f"window array must have shape ({n},), "
                             f"got {w.shape}")
        return jnp.asarray(w)
    m = n if periodic else n - 1
    j = np.arange(n, dtype=np.float64)
    if isinstance(window, tuple):
        name, *args = window
    else:
        name, args = window, ()
    if name == "boxcar":
        w = np.ones(n)
    elif name == "hann":
        w = 0.5 - 0.5 * np.cos(2 * np.pi * j / m)
    elif name == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * j / m)
    elif name == "blackman":
        w = (0.42 - 0.5 * np.cos(2 * np.pi * j / m)
             + 0.08 * np.cos(4 * np.pi * j / m))
    elif name == "bartlett":
        w = 1.0 - np.abs(2.0 * j / m - 1.0)
    elif name == "kaiser":
        beta = float(args[0]) if args else 8.6
        w = np.i0(beta * np.sqrt(np.clip(
            1.0 - (2.0 * j / m - 1.0) ** 2, 0.0, None))) / np.i0(beta)
    else:
        raise ValueError(f"unknown window {window!r}")
    return jnp.asarray(w.astype(np.float32))


def power_spectrum(x: jnp.ndarray, window: jnp.ndarray | None = None,
                   backend: str = "auto",
                   precision: str | None = None) -> jnp.ndarray:
    """One-sided power spectrum of real rows: (..., n) fp32 ->
    (..., n/2) fp32 with slot 0 = DC^2 and slot k = |X_k|^2.

    The Nyquist bin is omitted (packed slot-0 convention);
    spectral-search consumers discard DC/Nyquist.  The square fuses
    into the pass after the rfft.
    """
    from smfft import api

    n = x.shape[-1]
    if n not in P.SUPPORTED_REAL_SIZES or n < 256:
        raise ValueError(
            f"Error wrong FFT length! N={n}; power_spectrum supports "
            f"{[s for s in P.SUPPORTED_REAL_SIZES if s >= 256]}")
    xw = x if window is None else x * window
    spec = api.rfft(xw, backend=backend, precision=precision)
    pw = jnp.real(spec * jnp.conj(spec))[..., :n // 2]
    return pw.astype(jnp.float32)


def _spectral_scale(window: jnp.ndarray, fs: float, scaling: str,
                    n: int) -> tuple[float, float]:
    """(all-bin factor, one-sided doubling factor) for scipy parity."""
    w = np.asarray(window, np.float64)
    if scaling == "density":
        base = 1.0 / (fs * float(np.sum(w * w)))
    elif scaling == "spectrum":
        base = 1.0 / float(np.sum(w)) ** 2
    else:
        raise ValueError("scaling must be 'density' or 'spectrum'")
    return base, 2.0 * base


def _scale_onesided(pw: jnp.ndarray, base: float, double: float):
    """Apply scipy one-sided scaling: DC bin gets base, bins 1.. get
    2*base (the Nyquist bin, which would also get base, is omitted)."""
    scale = jnp.full((pw.shape[-1],), np.float32(double))
    scale = scale.at[0].set(np.float32(base))
    return pw * scale


def periodogram(x: jnp.ndarray, fs: float = 1.0, window="boxcar",
                detrend: str | bool = "constant",
                scaling: str = "density", backend: str = "auto",
                precision: str | None = None):
    """scipy.signal.periodogram over :func:`power_spectrum`.

    Returns (freqs (n/2,), Pxx (..., n/2)) — scipy's layout minus the
    Nyquist bin (see :func:`power_spectrum`).  ``detrend="constant"``
    subtracts the per-row mean (scipy default).
    """
    n = x.shape[-1]
    w = get_window(window, n)
    if detrend == "constant":
        x = x - jnp.mean(x, axis=-1, keepdims=True)
    elif detrend not in (False, None):
        raise ValueError("detrend must be 'constant' or False")
    pw = power_spectrum(x, window=w, backend=backend, precision=precision)
    base, double = _spectral_scale(w, fs, scaling, n)
    freqs = jnp.asarray(np.fft.rfftfreq(n, 1.0 / fs)[:n // 2]
                        .astype(np.float32))
    return freqs, _scale_onesided(pw, base, double)


def _frame(x: jnp.ndarray, nperseg: int, hop: int) -> jnp.ndarray:
    """(B, T) -> (B, F, nperseg) full frames (partial tail dropped);
    one XLA gather, which downstream window multiplies fuse into."""
    t = x.shape[-1]
    if t < nperseg:
        raise ValueError(f"signal length {t} < frame length {nperseg}")
    frames = 1 + (t - nperseg) // hop
    idx = (np.arange(frames)[:, None] * hop
           + np.arange(nperseg)[None, :])
    return x[..., idx]


def welch(x: jnp.ndarray, fs: float = 1.0, window="hann",
          nperseg: int = 1024, noverlap: int | None = None,
          detrend: str | bool = "constant", scaling: str = "density",
          backend: str = "auto", precision: str | None = None):
    """scipy.signal.welch over :func:`power_spectrum`: mean of windowed
    per-frame periodograms.  Returns (freqs (nperseg/2,),
    Pxx (..., nperseg/2)) — scipy's layout minus the Nyquist bin."""
    if noverlap is None:
        noverlap = nperseg // 2
    if not 0 <= noverlap < nperseg:
        raise ValueError(f"noverlap={noverlap} must be in [0, {nperseg})")
    fx = _frame(x, nperseg, nperseg - noverlap)
    w = get_window(window, nperseg)
    if detrend == "constant":
        fx = fx - jnp.mean(fx, axis=-1, keepdims=True)
    elif detrend not in (False, None):
        raise ValueError("detrend must be 'constant' or False")
    pw = power_spectrum(fx, window=w, backend=backend, precision=precision)
    base, double = _spectral_scale(w, fs, scaling, nperseg)
    freqs = jnp.asarray(np.fft.rfftfreq(nperseg, 1.0 / fs)[:nperseg // 2]
                        .astype(np.float32))
    return freqs, _scale_onesided(jnp.mean(pw, axis=-2), base, double)


def spectrogram(x: jnp.ndarray, fs: float = 1.0, window="hann",
                nperseg: int = 1024, noverlap: int | None = None,
                scaling: str = "density", backend: str = "auto",
                precision: str | None = None):
    """Power spectrogram: per-frame scaled periodograms (Welch without
    the mean).  Returns (freqs (nperseg/2,), times (F,),
    Sxx (..., F, nperseg/2))."""
    if noverlap is None:
        noverlap = nperseg // 2
    hop = nperseg - noverlap
    fx = _frame(x, nperseg, hop)
    w = get_window(window, nperseg)
    fx = fx - jnp.mean(fx, axis=-1, keepdims=True)
    pw = power_spectrum(fx, window=w, backend=backend, precision=precision)
    base, double = _spectral_scale(w, fs, scaling, nperseg)
    frames = fx.shape[-2]
    times = jnp.asarray(((np.arange(frames) * hop + nperseg / 2) / fs)
                        .astype(np.float32))
    freqs = jnp.asarray(np.fft.rfftfreq(nperseg, 1.0 / fs)[:nperseg // 2]
                        .astype(np.float32))
    return freqs, times, _scale_onesided(pw, base, double)


def stft(x: jnp.ndarray, n_fft: int = 1024, hop_length: int | None = None,
         window="hann", backend: str = "auto",
         precision: str | None = None) -> jnp.ndarray:
    """Short-time Fourier transform: (..., T) real -> (..., F, n_fft/2+1)
    complex (numpy rfft layout per frame, incl. the Nyquist bin).

    Frames start at multiples of ``hop_length`` (default n_fft//4) with
    no centering/padding — frame f covers samples
    [f*hop, f*hop + n_fft).  The window multiply fuses into the framing
    gather; each frame batch is one batched rfft.
    """
    from smfft import api

    hop = hop_length or n_fft // 4
    fx = _frame(x, n_fft, hop)
    w = get_window(window, n_fft)
    return api.rfft(fx * w, backend=backend, precision=precision)


def istft(z: jnp.ndarray, n_fft: int = 1024,
          hop_length: int | None = None, window="hann",
          length: int | None = None, backend: str = "auto",
          precision: str | None = None) -> jnp.ndarray:
    """Inverse STFT by windowed overlap-add (least-squares inverse with
    the same window; exact for COLA windows such as hann at hop
    n_fft//4 or n_fft//2).

    ``z``: (..., F, n_fft/2+1) complex frames from :func:`stft`.
    Returns (..., T) real with T = (F-1)*hop + n_fft (or ``length``).
    """
    from smfft import api

    hop = hop_length or n_fft // 4
    w = get_window(window, n_fft)
    frames = z.shape[-2]
    t_full = (frames - 1) * hop + n_fft
    y = api.irfft(z, n=n_fft, backend=backend,
                  precision=precision) * w          # (..., F, n_fft)
    # overlap-add via one scatter-add; window-square normalization
    idx = (np.arange(frames)[:, None] * hop
           + np.arange(n_fft)[None, :]).reshape(-1)
    batch_shape = z.shape[:-2]
    yf = y.reshape(batch_shape + (frames * n_fft,))
    out = jnp.zeros(batch_shape + (t_full,), yf.dtype)
    out = out.at[..., idx].add(yf)
    wsq = np.zeros(t_full, np.float64)
    np.add.at(wsq, idx, np.tile(np.asarray(w, np.float64) ** 2, frames))
    out = out / jnp.asarray(np.maximum(wsq, 1e-12).astype(np.float32))
    if length is not None:
        out = out[..., :length]
    return out
