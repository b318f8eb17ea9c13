"""Transform engines below the public API.

* :mod:`smfft.ops.matmul_fft` — the mixed-radix DFT-as-matmul engine at
  the jnp level, and the only engine with the digit-reversed
  ``ordered=False`` layout.
* :mod:`smfft.ops.fourstep` — the four-step decomposition of huge N into
  batched row transforms.
"""
