"""smfft — a batched small/medium FFT library in JAX.

Built in JAX/XLA with the capabilities of KAdamek/SMFFT: statically
specialized batched power-of-two fp32 FFTs (N = 32..16384 complex, up to
16384 real; the reference covers 32..4096), plus huge-N four-step
transforms, convolution and its template-bank form, N-D, Bluestein,
DCT/DST and signal-processing helpers.

Design:
  * Two transform engines behind one static-dispatch API
    (:mod:`smfft.api`): ``jax.numpy.fft`` (cuFFT on an NVIDIA GPU) and a
    mixed-radix DFT-as-matmul engine (:mod:`smfft.ops.matmul_fft`) whose
    digit-reversed layout is the analogue of the reference's
    ``fft_reorder=0`` output.  ``backend="auto"`` picks between them
    (``api._resolve_backend``).
  * Compile-time specialization happens through Python closures + jax.jit
    static arguments keyed on a frozen ``FFTParams`` plan — replacing the
    reference's FFT_Params template-class hierarchy
    (reference SMFFT_CooleyTukey_C2C/SM_FFT_parameters.cuh:1-390).
  * Batch parallelism across devices is plain sharding of the leading
    batch axis over a jax.sharding.Mesh; one huge transform can also be
    spread over a mesh (:mod:`smfft.parallel.distributed`).

Public API: :func:`fft`, :func:`ifft`, :func:`rfft`, :func:`irfft`,
:func:`convolve` and the rest in :mod:`smfft.api`; the same transforms on
separate real/imaginary arrays in :mod:`smfft.planar`.
"""

from smfft.params import (
    FFTParams,
    SUPPORTED_C2C_SIZES,
    SUPPORTED_REAL_SIZES,
    plan_for,
)
from smfft.api import (fft, ifft, ifft_unordered, rfft, irfft,
                       fft_packed_real, convolve, convolve_real,
                       fft_large, ifft_large, rfft_large, irfft_large)
from smfft.signal import (fftconvolve, get_window, power_spectrum,
                          periodogram, welch, spectrogram, stft,
                          istft)
from smfft.ndim import (fft2, ifft2, fftn, ifftn, rfft2, irfft2,
                        rfftn, irfftn, hfft, ihfft,
                        fftshift, ifftshift, fftfreq, rfftfreq)
from smfft.bluestein import (fft_any, ifft_any, rfft_any, irfft_any,
                             czt, zoom_fft)
from smfft.dct import (dct, idct, dst, idst, dctn, idctn, dstn,
                       idstn)
from smfft.signal import (oaconvolve, fftcorrelate, hilbert, envelope,
                          resample)

__version__ = "0.2.0"

__all__ = [
    "FFTParams",
    "SUPPORTED_C2C_SIZES",
    "SUPPORTED_REAL_SIZES",
    "plan_for",
    "fft",
    "ifft",
    "ifft_unordered",
    "rfft",
    "irfft",
    "fft_packed_real",
    "convolve",
    "convolve_real",
    "fft_large",
    "ifft_large",
    "rfft_large",
    "irfft_large",
    "fftconvolve",
    "get_window",
    "power_spectrum",
    "periodogram",
    "welch",
    "spectrogram",
    "stft",
    "istft",
    "fft2",
    "ifft2",
    "fftn",
    "ifftn",
    "rfft2",
    "irfft2",
    "fftshift",
    "ifftshift",
    "fftfreq",
    "rfftfreq",
    "fft_any",
    "ifft_any",
    "czt",
    "zoom_fft",
    "rfft_any",
    "irfft_any",
    "oaconvolve",
    "fftcorrelate",
    "hilbert",
    "envelope",
    "resample",
    "dct",
    "idct",
    "dst",
    "idst",
    "dctn",
    "idctn",
    "dstn",
    "idstn",
    "rfftn",
    "irfftn",
    "hfft",
    "ihfft",
]
