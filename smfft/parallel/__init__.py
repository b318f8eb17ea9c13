"""Multi-device parallelism.

The reference is strictly single-GPU (int device=0, FFT-GPU-32bit.cu:15;
no MPI/NCCL/streams — SURVEY.md §2.4).  Its one parallelism axis is the
batch (grid of independent FFT blocks), which maps to sharding the
leading batch axis of the input across a jax.sharding.Mesh
(:mod:`smfft.parallel.sharding`): embarrassingly parallel, zero
collectives.

Beyond the reference, :mod:`smfft.parallel.distributed` computes ONE
transform sharded along the transform axis (four-step decomposition with
all_to_all transposes between devices) for N up to 2**28.
"""

from smfft.parallel.sharding import (  # noqa: F401
    batch_mesh,
    shard_batch,
    sharded_convolve,
    sharded_fft,
)
from smfft.parallel.distributed import (  # noqa: F401
    distributed_fft,
    distributed_ifft,
    distributed_irfft,
    distributed_rfft,
    plan_distributed,
)
