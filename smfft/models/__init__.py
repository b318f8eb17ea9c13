"""Transform families — one module per reference variant directory.

* :mod:`smfft.models.cooley_tukey` — radix-2 decimation-in-time family
  (reference ``SMFFT_CooleyTukey_C2C/``), with ordered and bit-reversed
  ("noreorder") output contracts.
* :mod:`smfft.models.stockham` — Stockham autosort family
  (reference ``SMFFT_Stockham_C2C/``), always ordered.
* :mod:`smfft.models.real` — real-transform family via the half-size
  packing trick (reference ``SMFFT_Stockham_R2C_C2R/``).

These are pure-jnp, batch-vectorized *semantic specifications*: small,
obviously-correct implementations validated against numpy.fft that define
the exact output contract (ordering, packing, normalization) the engines
in :mod:`smfft.api` must reproduce bit-for-contract.
"""

from smfft.models import cooley_tukey, stockham, real  # noqa: F401
