"""Distributed single-transform FFT over a device mesh (collectives).

`sharding.py` scales the reference's one parallel axis — the batch
(one FFT per CUDA block, FFT-GPU-32bit.cu:586-595) — with zero
collectives.  This module goes beyond the reference: ONE transform whose
length exceeds a single device's memory is computed across the mesh
with the four-step decomposition (ops/fourstep.py), where the
inter-stage transposes become `lax.all_to_all` collectives (NCCL over
NVLink between the GPUs of one host):

    global A (N1, N2), columns sharded          local (N1, N2/d)
    stage 1: row FFT_N1 of A^T (local)          local (N2/d, N1)
    twiddle W_N^(n2*k1) (local, exact)          n2 offset = shard index
    ALL-TO-ALL: reshard rows->cols              local (N2, N1/d)
    stage 2: row FFT_N2 of C^T (local)          local (N1/d, N2)
    [natural order: ALL-TO-ALL + transpose]     local (N2/d, N1)

With ``transposed_output=True`` the final collective is skipped and the
result is the (N1, N2) matrix C with C[k1, k2] = X[k2*N1 + k1], k1
sharded — the FFTW MPI ``FFTW_MPI_TRANSPOSED_OUT`` contract.  The
inverse accepts that matrix directly (``transposed_input=True``): its
LOCAL transpose is exactly the column-sharded four-step input of the
inverse transform with swapped factors (X.reshape(N2, N1) = C^T), so the
same body runs with zero extra communication — a spectral round trip
(forward, pointwise multiply in C-layout, inverse) pays 3 collectives
instead of 4.

Every local stage is a batched row transform on that device's shard;
the only cross-device traffic is the transpose collectives.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PSpec

from smfft.ops import fourstep
from smfft.parallel.sharding import _shard_map


def _mesh_size(mesh: Mesh, axis_name: str) -> int:
    if axis_name not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis_name!r}: {mesh.shape}")
    return mesh.shape[axis_name]


def plan_distributed(n: int, d: int) -> tuple[int, int]:
    """N = N1 * N2 with both factors supported row sizes divisible by the
    mesh size d (each shard must hold whole rows/columns)."""
    n1, n2 = fourstep.split_factors(n)
    if n1 % d or n2 % d:
        raise ValueError(
            f"Error wrong FFT length! N={n} = {n1}*{n2} is not divisible "
            f"by a {d}-device mesh (need d | {n2}); use a smaller mesh or "
            f"a larger N")
    return n1, n2


def _local_four_step(a_loc: jnp.ndarray, *, n: int, n1: int, n2: int,
                     d: int, inverse: bool, pre_transpose: bool,
                     transposed_out: bool, backend: str,
                     precision: str | None, axis_name: str) -> jnp.ndarray:
    """Per-device four-step body (runs under shard_map).

    ``a_loc`` is (B, n1, n2/d) — this chip's column block of the
    (B, n1, n2) input matrices — or, with ``pre_transpose``, the
    (B, n2/d, n1) local block of its distributed transpose (the
    transposed-output C-matrix of a prior forward, whose local transpose
    IS the column-sharded input of the inverse with swapped factors).
    """
    if pre_transpose:
        a_loc = jnp.swapaxes(a_loc, -1, -2)
    idx = jax.lax.axis_index(axis_name)
    # stage 1: FFT over n1 (length n1) at this chip's n2-column block
    b = fourstep._row_fft(jnp.swapaxes(a_loc, -1, -2), inverse, backend,
                          precision)                      # (B, n2/d, n1)
    off = idx * (n2 // d)
    n2_global = off + jnp.arange(n2 // d, dtype=jnp.uint32)
    b = fourstep.twiddle_rows(b, n2_global, n, inverse)
    # reshard rows->cols: (B, n2/d, n1) -> (B, n2, n1/d)
    c = jax.lax.all_to_all(b, axis_name, split_axis=2, concat_axis=1,
                           tiled=True)
    # stage 2: FFT over n2 (length n2) at this chip's k1-row block
    out = fourstep._row_fft(jnp.swapaxes(c, -1, -2), inverse, backend,
                            precision)                    # (B, n1/d, n2)
    if transposed_out:
        return out  # C[k1, k2] row block: X[k2*n1 + k1]
    # natural order: reshard back and transpose locally ->
    # X.reshape(n2, n1) row block
    e = jax.lax.all_to_all(out, axis_name, split_axis=2, concat_axis=1,
                           tiled=True)                    # (B, n1, n2/d)
    return jnp.swapaxes(e, -1, -2)                        # (B, n2/d, n1)


def _dist_c2c(x: jnp.ndarray, mesh: Mesh, *, inverse: bool,
              transposed_input: bool, transposed_output: bool,
              backend: str, precision: str | None, norm: str | None,
              axis_name: str) -> jnp.ndarray:
    """Batched distributed C2C core: x is (..., N) (any leading batch
    dims, including none), or the (..., N1, N2) C-matrix with
    ``transposed_input``."""
    d = _mesh_size(mesh, axis_name)
    if transposed_input:
        if transposed_output:
            raise ValueError("transposed_input with transposed_output "
                             "is not supported; the round-trip contract "
                             "is forward(transposed_output=True) -> "
                             "inverse(transposed_input=True) -> natural")
        if x.ndim < 2:
            raise ValueError("transposed_input expects the (..., N1, N2) "
                             "C-matrix a transposed-output forward "
                             "returned")
        batch = x.shape[:-2]
        fn1, fn2 = x.shape[-2:]       # forward factors
        n = fn1 * fn2
        if (fn1, fn2) != plan_distributed(n, d):
            raise ValueError(
                f"unexpected transposed shape {x.shape[-2:]}; "
                f"expected {plan_distributed(n, d)}")
        # C^T = X.reshape(fn2, fn1): the inverse runs the standard body
        # with swapped factors; only a LOCAL transpose is needed, done
        # inside the shard_map body (pre_transpose).
        n1, n2 = fn2, fn1
        a = x.reshape((-1, fn1, fn2))
        in_spec = PSpec(None, axis_name, None)   # k1-rows sharded
    else:
        batch = x.shape[:-1]
        n = x.shape[-1]
        n1, n2 = plan_distributed(n, d)
        a = x.reshape(-1, n1, n2)
        in_spec = PSpec(None, None, axis_name)   # n2-columns sharded
    out_spec = PSpec(None, axis_name, None)
    body = partial(
        _local_four_step, n=n, n1=n1, n2=n2, d=d, inverse=inverse,
        pre_transpose=transposed_input, transposed_out=transposed_output,
        backend=backend, precision=precision, axis_name=axis_name)
    mapped = _shard_map(body, mesh, (in_spec,), out_spec)
    a = jax.device_put(a, NamedSharding(mesh, in_spec))
    out = jax.jit(mapped,
                  out_shardings=NamedSharding(mesh, out_spec))(a)
    if inverse and norm == "backward":
        out = out / n
    if transposed_output:
        # (..., n1, n2) C-matrix, k1 sharded
        return out.reshape(batch + (n1, n2))
    # natural order, sharded blocks
    return out.reshape(batch + (n,))


def distributed_fft(x: jnp.ndarray, mesh: Mesh, *,
                    transposed_output: bool = False,
                    backend: str = "auto", precision: str | None = None,
                    axis_name: str = "fft") -> jnp.ndarray:
    """Forward C2C FFT of huge vectors, each sharded over the mesh.

    Args:
      x: complex64 (..., N) — one vector or a batch (every transform is
        mesh-distributed; shard the batch with parallel.sharding instead
        when transforms fit one chip).  N = N1*N2 a power of two with
        both balanced factors supported row sizes divisible by the mesh
        size (N in [1024, 2**28] for mesh sizes up to 32).
      transposed_output: skip the final all_to_all and return the
        (N1, N2) matrix C with C[k1, k2] = X[k2*N1 + k1], k1 sharded
        (FFTW_MPI_TRANSPOSED_OUT); feed it back via
        ``distributed_ifft(..., transposed_input=True)``.

    Returns the natural-order spectrum (N,) sharded in contiguous blocks
    unless ``transposed_output``.
    """
    return _dist_c2c(x, mesh, inverse=False, transposed_input=False,
                     transposed_output=transposed_output, backend=backend,
                     precision=precision, norm=None, axis_name=axis_name)


def distributed_ifft(x: jnp.ndarray, mesh: Mesh, *,
                     transposed_input: bool = False,
                     norm: str | None = "backward",
                     backend: str = "auto", precision: str | None = None,
                     axis_name: str = "fft") -> jnp.ndarray:
    """Inverse of :func:`distributed_fft`, returning natural-order time
    samples (..., N).

    With ``transposed_input=True`` x is the (..., N1, N2) C-matrix a
    transposed-output forward returned (k1 sharded); the inverse consumes
    it with no extra communication (local transpose + swapped factors).
    ``norm="backward"`` divides by N; ``norm=None`` keeps the reference's
    raw unnormalized inverse (SURVEY.md quirk 3).
    """
    return _dist_c2c(x, mesh, inverse=True,
                     transposed_input=transposed_input,
                     transposed_output=False, backend=backend,
                     precision=precision, norm=norm, axis_name=axis_name)


# ---------------------------------------------------------------------------
# distributed real transforms: the reference pack trick
# (SMFFT_Stockham_R2C_C2R/FFT-GPU-32bit-Stockham.cu:269-344) at mesh scale
# ---------------------------------------------------------------------------

def _mirror_shards(z: jnp.ndarray, d: int, axis_name: str) -> jnp.ndarray:
    """Zrev[..., k] = Z[..., (L - k) % L] on block-sharded rows: local
    lane flip, shard-reversing ppermute, then a one-element cyclic-shift
    ppermute for the (L - k) offset.  Two tiny collectives per call."""
    zf = jnp.flip(z, axis=-1)
    # shard s's flipped block belongs at position d-1-s of the global
    # flip; after this permute shard t holds Zflip[t*c : (t+1)*c] with
    # Zflip[j] = Z[L-1-j]
    zf = jax.lax.ppermute(zf, axis_name,
                          perm=[(s, d - 1 - s) for s in range(d)])
    # Zrev[k] = Zflip[(k - 1) mod L]: shift right by one across the
    # shard boundary (cyclic — shard 0's first element is Z[0])
    last = zf[..., -1:]
    prev_last = jax.lax.ppermute(
        last, axis_name, perm=[(s, (s + 1) % d) for s in range(d)])
    return jnp.concatenate([prev_last, zf[..., :-1]], axis=-1)


def _wk_block(n: int, L: int, d: int, inverse: bool,
              axis_name: str):
    """(wr, wi) fp32 (c,) of W_N^k for this shard's global k block,
    assembled from the exact hi/lo split tables (fourstep.py)."""
    c = L // d
    idx = jax.lax.axis_index(axis_name)
    lo_bits = min(fourstep._LO_BITS, n.bit_length() - 1)
    lo_r, lo_i, hi_r, hi_i = (
        jnp.asarray(t) for t in fourstep._twiddle_tables(n, inverse))
    k = idx * c + jnp.arange(c, dtype=jnp.uint32)
    ih = (k >> lo_bits).astype(jnp.int32)
    il = (k & jnp.uint32((1 << lo_bits) - 1)).astype(jnp.int32)
    wr = hi_r[ih] * lo_r[il] - hi_i[ih] * lo_i[il]
    wi = hi_r[ih] * lo_i[il] + hi_i[ih] * lo_r[il]
    return wr, wi


def _split_body(z: jnp.ndarray, *, n: int, L: int, d: int,
                axis_name: str) -> jnp.ndarray:
    """Forward Hermitian split under shard_map: Z = FFT_L(packed x) ->
    packed half-spectrum X (slot 0 = DC + i*Nyq on shard 0)."""
    zm = _mirror_shards(z, d, axis_name)
    zr, zi = jnp.real(z), jnp.imag(z)
    mr, mi = jnp.real(zm), jnp.imag(zm)
    er, ei = 0.5 * (zr + mr), 0.5 * (zi - mi)
    or_, oi = 0.5 * (zi + mi), 0.5 * (mr - zr)
    wr, wi = _wk_block(n, L, d, False, axis_name)
    xr = er + wr * or_ - wi * oi
    xi = ei + wr * oi + wi * or_
    # slot 0 on shard 0: DC + i*Nyq (reference packed layout)
    idx = jax.lax.axis_index(axis_name)
    lane = jax.lax.broadcasted_iota(jnp.int32, xr.shape, xr.ndim - 1)
    first = (lane == 0) & (idx == 0)
    xr = jnp.where(first, zr[..., :1] + zi[..., :1], xr)
    xi = jnp.where(first, zr[..., :1] - zi[..., :1], xi)
    return jax.lax.complex(xr, xi)


def _merge_body(h: jnp.ndarray, *, n: int, L: int, d: int,
                axis_name: str) -> jnp.ndarray:
    """Inverse merge under shard_map: packed half-spectrum -> the
    pre-processed z whose inverse FFT_L is the packed signal."""
    idx = jax.lax.axis_index(axis_name)
    lane = jax.lax.broadcasted_iota(jnp.int32, h.shape, h.ndim - 1)
    first = (lane == 0) & (idx == 0)
    hr, hi = jnp.real(h), jnp.imag(h)
    # X[0] = DC (real); the mirror side M[0] = Nyq (real)
    xr = jnp.where(first, hr[..., :1], hr)
    xi = jnp.where(first, jnp.zeros_like(hi), hi)
    x = jax.lax.complex(xr, xi)
    m = _mirror_shards(x, d, axis_name)
    mr, mi = jnp.real(m), jnp.imag(m)
    mr = jnp.where(first, hi[..., :1], mr)
    mi = jnp.where(first, jnp.zeros_like(mi), mi)
    er, ei = 0.5 * (xr + mr), 0.5 * (xi - mi)
    tr, ti = 0.5 * (xr - mr), 0.5 * (xi + mi)
    wr, wi = _wk_block(n, L, d, True, axis_name)
    or_, oi = tr * wr - ti * wi, tr * wi + ti * wr
    return jax.lax.complex(er - oi, ei + or_)


def distributed_rfft(x: jnp.ndarray, mesh: Mesh, *,
                     backend: str = "auto", precision: str | None = None,
                     axis_name: str = "fft") -> jnp.ndarray:
    """Distributed R2C via the reference pack trick: real (..., N) ->
    packed complex half-spectrum (..., N/2), slot 0 = DC + i*Nyquist,
    natural order, block-sharded over the mesh.  Costs one distributed
    C2C of length N/2 plus three tiny ppermute collectives.

    Reference anchor: SMFFT_Stockham_R2C_C2R packs two real points per
    complex slot (FFT-GPU-32bit-Stockham.cu:269-344); here the split
    runs as a sharded epilogue with exact W_N^k tables."""
    n = x.shape[-1]
    fourstep._check_real_n(n)
    L = n // 2
    d = _mesh_size(mesh, axis_name)
    batch = x.shape[:-1]
    xp = jnp.asarray(x, jnp.float32).reshape(batch + (L, 2))
    z = jax.lax.complex(xp[..., 0], xp[..., 1])
    zf = _dist_c2c(z, mesh, inverse=False, transposed_input=False,
                   transposed_output=False, backend=backend,
                   precision=precision, norm=None, axis_name=axis_name)
    spec = PSpec(*((None,) * len(batch) + (axis_name,))) \
        if batch else PSpec(axis_name)
    body = partial(_split_body, n=n, L=L, d=d, axis_name=axis_name)
    mapped = _shard_map(body, mesh, (spec,), spec)
    zf = jax.device_put(zf, NamedSharding(mesh, spec))
    return jax.jit(mapped, out_shardings=NamedSharding(mesh, spec))(zf)


def distributed_irfft(h: jnp.ndarray, mesh: Mesh, *,
                      normalize: bool = True, backend: str = "auto",
                      precision: str | None = None,
                      axis_name: str = "fft") -> jnp.ndarray:
    """Inverse of :func:`distributed_rfft`: packed half-spectrum
    (..., N/2) -> real (..., N).  ``normalize`` divides by N/2 (the
    numpy-parity signal); ``normalize=False`` keeps the reference's raw
    (N/2)-scale (SMFFT_Stockham_R2C_C2R/FFT.c:170-171)."""
    L = h.shape[-1]
    n = 2 * L
    fourstep._check_real_n(n)
    d = _mesh_size(mesh, axis_name)
    batch = h.shape[:-1]
    spec = PSpec(*((None,) * len(batch) + (axis_name,))) \
        if batch else PSpec(axis_name)
    body = partial(_merge_body, n=n, L=L, d=d, axis_name=axis_name)
    mapped = _shard_map(body, mesh, (spec,), spec)
    h = jax.device_put(jnp.asarray(h, jnp.complex64),
                       NamedSharding(mesh, spec))
    z = jax.jit(mapped, out_shardings=NamedSharding(mesh, spec))(h)
    zi = _dist_c2c(z, mesh, inverse=True, transposed_input=False,
                   transposed_output=False, backend=backend,
                   precision=precision,
                   norm=None, axis_name=axis_name)
    if normalize:
        zi = zi / L
    out = jnp.stack([jnp.real(zi), jnp.imag(zi)], axis=-1)
    return out.reshape(batch + (n,))
