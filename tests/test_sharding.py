"""Multi-chip batch-sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from smfft.parallel import batch_mesh, shard_batch, sharded_fft
from smfft.parallel.sharding import sharded_rfft

from conftest import max_abs_err


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_sharded_fft_matches_numpy(rng):
    mesh = batch_mesh()
    x = (rng.random((64, 256)) + 1j * rng.random((64, 256))
         - 0.5 - 0.5j).astype(np.complex64)
    y = sharded_fft(jnp.array(x), mesh, backend="xla")
    assert max_abs_err(y, np.fft.fft(x.astype(np.complex128))) < 1e-4
    # output stays batch-sharded over all 8 devices
    assert len(y.sharding.device_set) == 8


def test_shard_batch_placement(rng):
    mesh = batch_mesh()
    x = jnp.zeros((64, 512), jnp.float32)
    xs = shard_batch(x, mesh)
    assert len(xs.sharding.device_set) == 8
    shard_shapes = {s.data.shape for s in xs.addressable_shards}
    assert shard_shapes == {(8, 512)}


def test_sharded_rfft(rng):
    mesh = batch_mesh()
    x = (rng.random((64, 512)) - 0.5).astype(np.float32)
    y = sharded_rfft(jnp.array(x), mesh, backend="xla")
    assert max_abs_err(y, np.fft.rfft(x.astype(np.float64))) < 1e-4


def test_sharded_irfft(rng):
    from smfft.parallel.sharding import sharded_irfft

    mesh = batch_mesh()
    x = (rng.random((64, 512)) - 0.5).astype(np.float32)
    spec = np.fft.rfft(x.astype(np.float64)).astype(np.complex64)
    back = sharded_irfft(jnp.array(spec), mesh, 512, backend="xla")
    assert max_abs_err(back, x) < 1e-4
    assert len(back.sharding.device_set) == 8


def test_sharded_fft_jnp_route(rng):
    """The jnp.fft route partitioned over the 8-device mesh: each device
    transforms its 8-row shard."""
    mesh = batch_mesh()
    n = 1024
    x = (rng.random((64, n)) + 1j * rng.random((64, n))
         - 0.5 - 0.5j).astype(np.complex64)
    y = sharded_fft(jnp.array(x), mesh, backend="jnp")
    assert len(y.sharding.device_set) == 8
    assert max_abs_err(y, np.fft.fft(x.astype(np.complex128))) < 1e-3


def test_sharded_convolve(rng):
    """Batch-sharded convolution: signals sharded, the filter bank
    replicated — every device convolves its local rows against the full
    bank (matmul engine and jnp.fft route)."""
    from smfft.parallel import sharded_convolve

    mesh = batch_mesh()
    n, m = 256, 2
    x = (rng.random((64, n)) + 1j * rng.random((64, n))
         - 0.5 - 0.5j).astype(np.complex64)
    hs = (rng.random((m, n)) + 1j * rng.random((m, n))
          - 0.5 - 0.5j).astype(np.complex64)
    ref = np.fft.ifft(np.fft.fft(x.astype(np.complex128))[None]
                      * hs.astype(np.complex128)[:, None])
    y = sharded_convolve(jnp.array(x), jnp.array(hs), mesh, backend="xla")
    assert y.shape == (m, 64, n)
    assert len(y.sharding.device_set) == 8
    assert max_abs_err(y, ref) < 1e-4
    yp = sharded_convolve(jnp.array(x), jnp.array(hs), mesh, backend="jnp")
    assert len(yp.sharding.device_set) == 8
    assert max_abs_err(yp, ref) < 1e-4


def test_sharded_inverse_roundtrip(rng):
    mesh = batch_mesh()
    x = (rng.random((64, 1024)) + 1j * rng.random((64, 1024))
         - 0.5 - 0.5j).astype(np.complex64)
    y = sharded_fft(jnp.array(x), mesh, backend="xla")
    back = sharded_fft(y, mesh, inverse=True, backend="xla")
    assert max_abs_err(back, x) < 1e-5


@pytest.mark.parametrize("backend", ["jnp", "xla"])
def test_sharded_fft_has_no_collectives(backend):
    """Each device transforms only its own rows: the compiled program
    moves no data between devices (XLA's SPMD partitioner would gather
    the whole batch around a jnp.fft)."""
    from functools import partial
    mesh = batch_mesh()
    x = shard_batch(jnp.zeros((64, 256), jnp.complex64), mesh)
    txt = jax.jit(partial(sharded_fft, mesh=mesh, backend=backend)).lower(
        x).compile().as_text()
    for op in ("all-gather", "all-to-all", "all-reduce",
               "collective-permute"):
        assert op not in txt, op
