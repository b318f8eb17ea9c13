"""Batch sharding of FFT workloads over a device mesh.

The reference's only parallelism is one FFT per CUDA block over a grid
(FFT-GPU-32bit.cu:586-595) in a single GPU.  The scale-out of the same
design across devices is data parallelism over the batch axis: each
device runs the identical transform on its shard; there is no cross-FFT
data flow, so no collectives are inserted (SURVEY.md §2.4 — "do not
invent" axes the reference doesn't have).

Usage:
    mesh = batch_mesh()                       # all devices on axis "batch"
    y = sharded_fft(x, mesh)                  # x: (B, N) complex, B % ndev == 0
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PSpec


def batch_mesh(devices=None, axis_name: str = "batch") -> Mesh:
    """1-D mesh over all (or given) devices, batch axis only."""
    devices = np.array(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (axis_name,))


def shard_batch(x: jnp.ndarray, mesh: Mesh, axis_name: str = "batch"):
    """Place x with its leading axis sharded over the mesh."""
    spec = PSpec(axis_name, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def _shard_map(fn, mesh: Mesh, in_specs, out_specs):
    """jax.shard_map without its replication check: the four-step bodies
    of distributed.py mix axis_index-derived and collective values."""
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def _batch_parallel(fn, mesh: Mesh, args, specs, out_spec):
    """Run fn on each device's local shard (shard_map), with each
    argument placed by its spec.  XLA's SPMD partitioner does not split
    an FFT along its batch axes — it gathers the whole batch onto every
    device — so the per-device mapping is explicit."""
    args = [jax.device_put(a, NamedSharding(mesh, sp))
            for a, sp in zip(args, specs)]
    mapped = _shard_map(fn, mesh, tuple(specs), out_spec)
    return jax.jit(mapped, out_shardings=NamedSharding(mesh, out_spec))(
        *args)


def _rows(ndim: int, axis_name: str) -> PSpec:
    return PSpec(axis_name, *([None] * (ndim - 1)))


def sharded_fft(x: jnp.ndarray, mesh: Mesh, *, inverse: bool = False,
                ordered: bool = True, backend: str = "auto",
                precision: str = "highest", axis_name: str = "batch"):
    """Batched C2C FFT with the batch axis sharded across the mesh: each
    device transforms its B/ndev rows, with zero collectives."""
    from smfft import api

    fn = partial(api.ifft if inverse else api.fft, ordered=ordered,
                 backend=backend, precision=precision)
    spec = _rows(x.ndim, axis_name)
    return _batch_parallel(fn, mesh, (x,), (spec,), spec)


def sharded_rfft(x: jnp.ndarray, mesh: Mesh, *, backend: str = "auto",
                 precision: str = "highest", axis_name: str = "batch"):
    """Batched R2C with the batch axis sharded across the mesh."""
    from smfft import api

    fn = partial(api.rfft, backend=backend, precision=precision)
    spec = _rows(x.ndim, axis_name)
    return _batch_parallel(fn, mesh, (x,), (spec,), spec)


def sharded_convolve(x: jnp.ndarray, h: jnp.ndarray, mesh: Mesh, *,
                     backend: str = "auto", precision: str = "highest",
                     axis_name: str = "batch"):
    """Circular convolution with the batch axis sharded across the mesh
    and the filter (or (M, N) bank) replicated to every device — the
    batch-parallel matched-filter shape: zero collectives, each device
    convolves its local rows against the full template bank."""
    from smfft import api

    fn = partial(api.convolve, backend=backend, precision=precision)
    bank_dims = 1 if h.ndim == 2 else 0
    out_spec = PSpec(*([None] * bank_dims), axis_name,
                     *([None] * (x.ndim - 1)))
    return _batch_parallel(fn, mesh, (x, h),
                           (_rows(x.ndim, axis_name), PSpec()), out_spec)


def sharded_irfft(spec_arr: jnp.ndarray, mesh: Mesh, n: int, *,
                  backend: str = "auto", precision: str = "highest",
                  norm: str | None = "backward",
                  axis_name: str = "batch"):
    """Batched C2R inverse with the batch axis sharded across the mesh."""
    from smfft import api

    fn = partial(api.irfft, n=n, backend=backend, precision=precision,
                 norm=norm)
    spec = _rows(spec_arr.ndim, axis_name)
    return _batch_parallel(fn, mesh, (spec_arr,), (spec,), spec)
