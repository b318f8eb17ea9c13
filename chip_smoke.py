#!/usr/bin/env python
"""Bring-up smoke for smfft on NVIDIA GPUs: the main path at full size,
checked against numpy float64 and timed.

Run from the repository root:

    python chip_smoke.py             # one GPU: phases 1-4 below
    python chip_smoke.py --chips 4   # four GPUs of one host: the
                                     # multi-device path only

Phases, in order; the first failure ends the run with a non-zero exit:

1. device — JAX must see GPUs (no CPU fallback); prints the card's name
   and power limit as ``nvidia-smi`` reports them.
2. compile and check at real widths — every main-path entry point
   compiled at its full size (4 GiB of input for each row size, the
   matched-filter bank, huge N at batch 1), ``memory_analysis()``
   printed, inputs drawn on the device from a seed, outputs compared
   with numpy float64 over the first and last 256 rows (the whole
   transform at batch 1).  "highest", "high" and "exact" are held to
   2e-7 * N**0.75 * 8 max abs error; "high" also to the reference's 1e-4
   gate; "fast" and "default" print the error they reach.
3. route timing — the jnp.fft route against the matmul engine at every
   size, forward and inverse, C2C and real, and the digit-reversed
   ``ordered=False`` / ``ifft_unordered`` pair; jnp.fft at full length
   against the four-step for huge N; convolution against one FFT over
   the same bytes; a large elementwise pass as the copy yardstick.
   Inverses are timed with numpy's normalization, the API default.  Host
   clock around block_until_ready, compile and warm-up excluded; short
   calls run back to back in windows of at least 20 ms; GB/s counts
   input plus output bytes.
4. the ``gpu``-marked tests, run in this process by ``pytest.main``.

Everything is printed; the full record also goes to
``chiprun_out/chip_smoke_report.json``.  The last line of standard
output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
REPORT = REPO / "chiprun_out" / "chip_smoke_report.json"
CHECK_ROWS = 256


class SmokeFailure(RuntimeError):
    """A phase failed; the run stops with a non-zero exit."""


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Problem sizes of the one-device phases."""
    c2c: tuple[int, ...]          # row lengths, complex
    real: tuple[int, ...]         # row lengths, real
    c2c_elems: int                # complex elements per batch
    real_elems: int               # real samples per batch
    huge: tuple[int, ...]         # huge N, batch 1
    bank: tuple[int, int, int]    # (N real, M templates, streams)
    conv_n: int                   # row length of the convolution checks
    any_n: int                    # a non-power-of-two length (Bluestein)
    reps: int = 5


def full_sizes() -> Sizes:
    """The reference's external benchmark size (BASELINE.md): 4 GiB of
    complex64 input for each N, the same bytes as 2**30 real samples,
    the matched-filter bank of examples/matched_filter.py at 4 GiB of
    output, and huge N at batch 1 (2**17: below the size from which
    ``auto`` takes jnp.fft at full length)."""
    from smfft import params as P
    return Sizes(c2c=P.SUPPORTED_C2C_SIZES, real=P.SUPPORTED_REAL_SIZES,
                 c2c_elems=1 << 29, real_elems=1 << 30,
                 huge=(1 << 17, 1 << 20, 1 << 24, 1 << 27),
                 bank=(4096, 8, 32768),
                 conv_n=4096, any_n=1000)


@dataclasses.dataclass(frozen=True)
class MultiSizes:
    """Problem sizes of the four-device path."""
    dist_n: int                   # one distributed transform
    batch_n: int                  # row length of the sharded batch
    batch_elems: int              # complex elements of the sharded batch
    bank: tuple[int, int, int]    # (N, M templates, streams), complex
    reps: int = 5


def full_multi_sizes() -> MultiSizes:
    return MultiSizes(dist_n=1 << 28, batch_n=4096, batch_elems=1 << 29,
                      bank=(4096, 8, 1 << 14))


# ---------------------------------------------------------------------------
# the record
# ---------------------------------------------------------------------------


class Report:
    """Prints each result as one line and keeps it for the JSON record."""

    def __init__(self, card: str = "not read"):
        self.card = card
        self.entries: list[dict] = []

    def add(self, tag: str, **fields) -> dict:
        entry = {"tag": tag, **fields}
        self.entries.append(entry)
        text = " ".join(f"{k}={_fmt(v)}" for k, v in fields.items())
        print(f"[{tag}] {text}", flush=True)
        return entry

    def write(self, path: Path, ok: bool) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"ok": ok, "card": self.card,
                                    "entries": self.entries}, indent=1))


def _fmt(v):
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, str) and " " in v:
        return json.dumps(v)
    return str(v)


def bound(n: int) -> float:
    """The fp32 accuracy bound on unit-scale inputs: 2e-7 * N**0.75 * 8."""
    return 2e-7 * n ** 0.75 * 8


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------


def require_gpus(count: int = 1):
    """The first ``count`` JAX devices, which must be GPUs."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SmokeFailure(
            f"needs an NVIDIA GPU; JAX found {devices[0].platform} "
            f"({devices[0].device_kind}) — no CPU fallback")
    if len(devices) < count:
        raise SmokeFailure(f"needs {count} GPUs; JAX found {len(devices)}")
    return devices[:count]


def card_description() -> str:
    """``nvidia-smi --query-gpu=name,power.limit``, read by a child
    process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if not lines:
        raise SmokeFailure("nvidia-smi reported no GPU")
    return lines[0]


# ---------------------------------------------------------------------------
# inputs drawn on the device, host references
# ---------------------------------------------------------------------------


def _uniform(key, shape, dtype):
    """Unit-scale uniform [-1, 1) samples; complex draws both parts."""
    import jax
    import jax.numpy as jnp

    if dtype == jnp.complex64:
        kr, ki = jax.random.split(key)
        return jax.lax.complex(
            jax.random.uniform(kr, shape, jnp.float32, -1.0, 1.0),
            jax.random.uniform(ki, shape, jnp.float32, -1.0, 1.0))
    return jax.random.uniform(key, shape, jnp.float32, -1.0, 1.0)


def make_input(seed: int, shape: tuple[int, ...], kind: str):
    """A device array drawn from ``seed``: kind is "c64", "f32", or
    "half" (a Hermitian half-spectrum: DC and Nyquist real)."""
    import jax
    import jax.numpy as jnp

    def draw(key):
        if kind == "f32":
            return _uniform(key, shape, jnp.float32)
        z = _uniform(key, shape, jnp.complex64)
        if kind == "half":
            lane = jax.lax.broadcasted_iota(jnp.int32, shape, len(shape) - 1)
            edge = (lane == 0) | (lane == shape[-1] - 1)
            z = jnp.where(edge, jnp.real(z).astype(jnp.complex64), z)
        return z

    return jax.jit(draw)(jax.random.PRNGKey(seed))


def head_tail(a, rows: int = CHECK_ROWS, axis: int = 0) -> np.ndarray:
    """The first and last ``rows`` entries along ``axis`` (all of them
    when there are no more than 2 * rows), as float64/complex128."""
    n = a.shape[axis]
    if n <= 2 * rows:
        out = np.asarray(a)
    else:
        idx = np.concatenate([np.arange(rows), np.arange(n - rows, n)])
        import jax.numpy as jnp
        out = np.asarray(jnp.take(a, jnp.asarray(idx), axis=axis))
    return out.astype(np.complex128 if np.iscomplexobj(out)
                      else np.float64)


def max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def hybrid_gate_errors(got, want, tolerance: float = 1e-4) -> int:
    """Elements over the reference's 1e-4 gate under its hybrid metric
    (FFT.c:12, :23-49)."""
    from smfft import native
    st = native.compare(np.asarray(got, np.complex64).reshape(-1),
                        np.asarray(want, np.complex64).reshape(-1),
                        tolerance)
    return st["error_count"]


def compile_entry(rep: Report, name: str, fn, *args, cache=None):
    """AOT-compile fn for args' shapes; record compile time and
    ``memory_analysis()``; keep the executable in ``cache`` under
    ``name`` when one is given."""
    import jax

    specs = [jax.ShapeDtypeStruct(a.shape, a.dtype) for a in args]
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*specs).compile()
    secs = time.perf_counter() - t0
    m = compiled.memory_analysis()
    rep.add("compile", name=name, seconds=secs,
            argument_bytes=getattr(m, "argument_size_in_bytes", None),
            output_bytes=getattr(m, "output_size_in_bytes", None),
            temp_bytes=getattr(m, "temp_size_in_bytes", None))
    if cache is not None:
        cache[name] = compiled
    return compiled


# ---------------------------------------------------------------------------
# phase 2: compile and check at real widths
# ---------------------------------------------------------------------------


def _check(rep: Report, name: str, err: float, limit: float | None,
           **fields) -> None:
    ok = limit is None or err <= limit
    rep.add("check", name=name, max_abs_err=err,
            bound="printed only" if limit is None else limit,
            ok=ok, **fields)
    if not ok:
        raise SmokeFailure(f"{name}: max abs error {err!r} over {limit!r}")


def check_c2c(rep: Report, sizes: Sizes, cache: dict) -> None:
    """fft / ifft on the auto route, the unordered pair on the matmul
    engine, and every precision tier of the matmul engine."""
    import warnings

    import smfft as S
    from smfft import api, params as P
    from smfft.ops.matmul_fft import digit_reverse_indices

    for n in sizes.c2c:
        b = sizes.c2c_elems // n
        x = make_input(n, (b, n), "c64")
        xs = head_tail(x)
        ref = np.fft.fft(xs)
        ref_inv = np.fft.ifft(xs) * n
        route = api._resolve_backend("auto")

        def run(name, fn, want, limit, arg=x, **extra):
            y = compile_entry(rep, name, fn, arg, cache=cache)(arg)
            got = head_tail(y)
            del y
            _check(rep, name, max_abs(got, want), limit, n=n, batch=b,
                   **extra)
            return got

        run(f"fft n={n}", S.fft, ref, bound(n), route=route)
        run(f"ifft n={n}", lambda v: S.ifft(v, norm=None), ref_inv,
            bound(n), route=route)
        # the unordered pair on its own unit-scale input each:
        # natural[k] = unordered[perm[k]]
        perm = digit_reverse_indices(n, P.get_factorization(n))
        run(f"fft_unordered n={n}", lambda v: S.fft(v, ordered=False),
            ref[:, np.argsort(perm)], bound(n), route="xla")
        run(f"ifft_unordered n={n}",
            lambda v: S.ifft_unordered(v, norm=None),
            np.fft.ifft(xs[:, perm]) * n, bound(n), route="xla")
        for tier in ("highest", "exact", "high", "fast", "default"):
            name = f"fft xla {tier} n={n}"
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                got = run(name, lambda v, t=tier: S.fft(v, backend="xla",
                                                        precision=t),
                          ref, bound(n) if tier in ("highest", "exact",
                                                    "high") else None,
                          precision=tier)
            if tier == "high":
                over = hybrid_gate_errors(got, ref)
                rep.add("check", name=f"{name} 1e-4 gate",
                        elements_over=over, ok=over == 0)
                if over:
                    raise SmokeFailure(f"{name}: {over} elements over "
                                       f"the reference's 1e-4 gate")
        del x


def check_real(rep: Report, sizes: Sizes, cache: dict) -> None:
    """rfft, fft_packed_real and irfft on the auto route."""
    import smfft as S
    from smfft import api

    route = api._resolve_backend("auto")
    for n in sizes.real:
        b = sizes.real_elems // n
        x = make_input(n + 1, (b, n), "f32")
        xs = head_tail(x)
        ref = np.fft.rfft(xs)
        for name, fn, want in (
                (f"rfft n={n}", S.rfft, ref),
                (f"fft_packed_real n={n}", S.fft_packed_real,
                 np.concatenate([(ref[:, 0].real + 1j * ref[:, -1].real)
                                 [:, None], ref[:, 1:n // 2]], axis=1))):
            y = compile_entry(rep, name, fn, x, cache=cache)(x)
            _check(rep, name, max_abs(head_tail(y), want), bound(n), n=n,
                   batch=b, route=route)
            del y
        del x
        h = make_input(n + 2, (b, n // 2 + 1), "half")
        name = f"irfft n={n}"
        y = compile_entry(rep, name, lambda v, n=n: S.irfft(v, n=n, norm=None),
                          h, cache=cache)(h)
        want = np.fft.irfft(head_tail(h), n) * (n // 2)
        _check(rep, name, max_abs(head_tail(y), want), bound(n), n=n,
               batch=b, route=route)
        del y, h


def check_convolve(rep: Report, sizes: Sizes, cache: dict) -> None:
    """convolve / convolve_real, single filter and (M, N) bank."""
    import smfft as S

    n = sizes.conv_n
    nb, m, streams = sizes.bank
    cases = (
        # name, fn, signal (shape, kind), filter (shape, kind), reference
        (f"convolve n={n}", S.convolve,
         ((sizes.c2c_elems // n, n), "c64"), ((n,), "c64"),
         lambda x, h: np.fft.ifft(np.fft.fft(x) * h)),
        (f"convolve bank n={nb} m={m}", S.convolve,
         ((sizes.c2c_elems // (m * nb), nb), "c64"), ((m, nb), "c64"),
         lambda x, h: np.fft.ifft(np.fft.fft(x)[None] * h[:, None])),
        (f"convolve_real n={n}", S.convolve_real,
         ((sizes.real_elems // n, n), "f32"), ((n // 2 + 1,), "half"),
         lambda x, h: np.fft.irfft(np.fft.rfft(x) * h, x.shape[-1])),
        (f"convolve_real bank n={nb} m={m} streams={streams}",
         S.convolve_real, ((streams, nb), "f32"), ((m, nb // 2 + 1), "half"),
         lambda x, h: np.fft.irfft(np.fft.rfft(x)[None] * h[:, None],
                                   x.shape[-1])),
    )
    for seed, (name, fn, (xshape, xkind), (hshape, hkind), ref) in \
            enumerate(cases):
        x = make_input(11 + 2 * seed, xshape, xkind)
        h = make_input(12 + 2 * seed, hshape, hkind)
        y = compile_entry(rep, name, fn, x, h, cache=cache)(x, h)
        want = ref(head_tail(x), np.asarray(h).astype(np.complex128))
        got = head_tail(y, axis=y.ndim - 2)
        del x, y
        _check(rep, name, max_abs(got, want), bound(xshape[-1]),
               shape=f"{xshape}x{hshape}")


def check_huge(rep: Report, sizes: Sizes, cache: dict) -> None:
    """fft_large / ifft_large / rfft_large / irfft_large at batch 1,
    compared over the whole transform."""
    import smfft as S
    from smfft import api

    for n in sizes.huge:
        route = api._resolve_backend("auto", huge_elems=n)
        x = make_input(n + 3, (1, n), "c64")
        xs = np.asarray(x).astype(np.complex128)
        for name, fn, want in (
                (f"fft_large n={n}", S.fft_large, lambda: np.fft.fft(xs)),
                (f"ifft_large n={n}", lambda v: S.ifft_large(v, norm=None),
                 lambda: np.fft.ifft(xs) * n)):
            y = np.asarray(compile_entry(rep, name, fn, x, cache=cache)(x))
            _check(rep, name, max_abs(y, want()), bound(n), n=n, route=route)
            del y
        del x, xs
        r = make_input(n + 4, (1, n), "f32")
        name = f"rfft_large n={n}"
        y = np.asarray(compile_entry(rep, name, S.rfft_large, r,
                                     cache=cache)(r))
        _check(rep, name, max_abs(y, np.fft.rfft(np.asarray(r, np.float64))),
               bound(n), n=n, route=route)
        del y, r
        h = make_input(n + 5, (1, n // 2 + 1), "half")
        name = f"irfft_large n={n}"
        y = np.asarray(compile_entry(
            rep, name, lambda v, n=n: S.irfft_large(v, n=n, norm=None), h,
            cache=cache)(h))
        want = np.fft.irfft(np.asarray(h).astype(np.complex128), n) * (n // 2)
        _check(rep, name, max_abs(y, want), bound(n), n=n,
               route=api._resolve_backend("auto", huge_elems=h.size))
        del y, h


def check_planar(rep: Report, sizes: Sizes) -> None:
    """Every smfft.planar entry point once, at the convolution width (and
    the smallest huge N for the *_large forms)."""
    import jax.numpy as jnp

    from smfft import planar, params as P
    from smfft.ops.matmul_fft import digit_reverse_indices

    n = sizes.conv_n
    b = sizes.c2c_elems // n
    z = make_input(21, (b, n), "c64")
    vr, vi = jnp.real(z), jnp.imag(z)
    zs = head_tail(z)
    del z

    def planar_c(pair):
        return head_tail(pair[0]) + 1j * head_tail(pair[1])

    def run(name, fn, args, want, limit, n_):
        c = compile_entry(rep, f"planar.{name}", fn, *args)
        out = c(*args)
        got = planar_c(out) if isinstance(out, tuple) else head_tail(out)
        del out
        _check(rep, f"planar.{name}", max_abs(got, want), limit, n=n_)

    run(f"fft n={n}", planar.fft, (vr, vi), np.fft.fft(zs), bound(n), n)
    run(f"ifft n={n}", lambda a, c: planar.ifft(a, c, norm=None), (vr, vi),
        np.fft.ifft(zs) * n, bound(n), n)
    perm = digit_reverse_indices(n, P.get_factorization(n))
    inv = np.argsort(perm)
    run(f"fft unordered n={n}", lambda a, c: planar.fft(a, c, ordered=False),
        (vr, vi), np.fft.fft(zs)[:, inv], bound(n), n)
    run(f"ifft_unordered n={n}",
        lambda a, c: planar.ifft_unordered(a, c, norm=None), (vr, vi),
        np.fft.ifft(zs[:, perm]) * n, bound(n), n)
    hr, hi = vr[0], vi[0]
    hs = np.asarray(hr, np.float64) + 1j * np.asarray(hi, np.float64)
    run(f"convolve n={n}", planar.convolve, (vr, vi, hr, hi),
        np.fft.ifft(np.fft.fft(zs) * hs), bound(n), n)
    del vr, vi, hr, hi

    nr = sizes.conv_n
    x = make_input(22, (sizes.real_elems // nr, nr), "f32")
    xs = head_tail(x)
    spec = np.fft.rfft(xs)
    packed = np.concatenate([(spec[:, 0].real + 1j * spec[:, -1].real)
                             [:, None], spec[:, 1:nr // 2]], axis=1)
    run(f"rfft n={nr}", planar.rfft, (x,), packed, bound(nr), nr)
    half_perm = digit_reverse_indices(nr // 2, P.get_factorization(nr // 2))
    run(f"rfft unordered n={nr}", lambda a: planar.rfft(a, ordered=False),
        (x,), packed[:, np.argsort(half_perm)], bound(nr), nr)
    del x
    pk = make_input(23, (sizes.real_elems // nr, nr // 2), "c64")
    pks = head_tail(pk)
    pr, pi = jnp.real(pk), jnp.imag(pk)
    del pk
    full = np.concatenate([pks[:, :1].real, pks[:, 1:], pks[:, :1].imag],
                          axis=1)
    run(f"irfft n={nr}", lambda a, c: planar.irfft(a, c, norm=None),
        (pr, pi), np.fft.irfft(full, nr) * (nr // 2), bound(nr), nr)
    del pr, pi

    nh = sizes.huge[0]
    zh = make_input(24, (1, nh), "c64")
    zhs = np.asarray(zh).astype(np.complex128)
    hvr, hvi = jnp.real(zh), jnp.imag(zh)
    del zh
    run(f"fft_large n={nh}", planar.fft_large, (hvr, hvi),
        np.fft.fft(zhs), bound(nh), nh)
    run(f"ifft_large n={nh}",
        lambda a, c: planar.ifft_large(a, c, norm=None), (hvr, hvi),
        np.fft.ifft(zhs) * nh, bound(nh), nh)
    xr = make_input(25, (1, nh), "f32")
    sp = np.fft.rfft(np.asarray(xr, np.float64))
    run(f"rfft_large n={nh}", planar.rfft_large, (xr,),
        np.concatenate([(sp[:, 0].real + 1j * sp[:, -1].real)[:, None],
                        sp[:, 1:nh // 2]], axis=1), bound(nh), nh)
    full = np.concatenate([zhs[:, :1].real, zhs[:, 1:nh // 2],
                           zhs[:, :1].imag], axis=1)
    run(f"irfft_large n={nh}",
        lambda a, c: planar.irfft_large(a, c, norm=None),
        (hvr[:, :nh // 2], hvi[:, :nh // 2]),
        np.fft.irfft(full, nh) * (nh // 2), bound(nh), nh)

    na = sizes.any_n
    npad = -(-na // 128) * 128
    za = make_input(26, (sizes.c2c_elems // (4 * npad), na), "c64")
    zas = head_tail(za)
    pad = [(0, 0), (0, npad - na)]
    ar, ai = jnp.pad(jnp.real(za), pad), jnp.pad(jnp.imag(za), pad)
    del za
    want = np.pad(np.fft.fft(zas), pad)
    run(f"fft_any n={na}", lambda a, c: planar.fft_any(a, c, n=na),
        (ar, ai), want, bound(2 * npad), na)


# ---------------------------------------------------------------------------
# phase 3: route timing
# ---------------------------------------------------------------------------


WINDOW_S = 0.02          # the least host-clock window per sample
IN_FLIGHT_BYTES = 2 << 30  # the most output a window may leave queued


def calls_per_window(one_call_s: float, out_bytes: int) -> int:
    """Back-to-back calls in one timed window: enough to fill WINDOW_S,
    so a sub-millisecond call is not read off one host-clock interval,
    but no more than IN_FLIGHT_BYTES of outputs queued at once."""
    want = -(-WINDOW_S // max(one_call_s, 1e-9))
    return int(max(1, min(want, IN_FLIGHT_BYTES // max(out_bytes, 1))))


def time_call(fn, *args, reps: int) -> tuple[float, int, int]:
    """(median seconds per call over ``reps`` windows; bytes of the
    arguments plus the output; calls per window).  Each window issues
    its calls back to back and ends with block_until_ready on the last.
    One warm-up call first, so a jitted fn compiles outside the window."""
    import jax

    out = jax.block_until_ready(fn(*args))
    out_bytes = sum(a.nbytes for a in jax.tree_util.tree_leaves(out))
    moved = out_bytes + sum(a.nbytes for a in jax.tree_util.tree_leaves(args))
    del out
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    calls = calls_per_window(time.perf_counter() - t0, out_bytes)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls - 1):
            fn(*args)
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) / calls)
    return statistics.median(times), moved, calls


def timed(rep: Report, name: str, fn, args, reps: int, cache: dict,
          **fields) -> float:
    """Time the executable compiled under ``name`` in ``cache`` (compiling
    it first if there is none) and print GB/s of in+out traffic."""
    c = cache.get(name) or compile_entry(rep, name, fn, *args, cache=cache)
    secs, moved, calls = time_call(c, *args, reps=reps)
    rep.add("timing", name=name, ms=secs * 1e3, gbps=moved / secs / 1e9,
            bytes=moved, calls_per_window=calls, card=rep.card, **fields)
    return secs


def time_routes(rep: Report, sizes: Sizes, cache: dict) -> None:
    """Both engines at every row size and direction, huge N against the
    four-step, convolution against one FFT over the same bytes."""
    import smfft as S
    from smfft.ops import fourstep

    reps = sizes.reps
    x = make_input(31, (sizes.real_elems,), "f32")
    timed(rep, "copy yardstick (x * 2)", lambda v: v * 2.0, (x,), reps,
          cache, kind="copy")
    del x

    for n in sizes.c2c:
        x = make_input(n, (sizes.c2c_elems // n, n), "c64")
        for engine in ("jnp", "xla"):
            # the xla forward was compiled by the checks under this name
            fwd = f"fft xla highest n={n}" if engine == "xla" \
                else f"c2c fwd jnp n={n}"
            timed(rep, fwd, lambda v, e=engine: S.fft(v, backend=e), (x,),
                  reps, cache, engine=engine, n=n, kind="c2c",
                  direction="fwd")
            timed(rep, f"c2c inv {engine} n={n}",
                  lambda v, e=engine: S.ifft(v, backend=e), (x,),
                  reps, cache, engine=engine, n=n, kind="c2c",
                  direction="inv")
        # the digit-reversed pair, the one layout auto leaves on the
        # matmul engine (the forward was compiled by the checks)
        timed(rep, f"fft_unordered n={n}",
              lambda v: S.fft(v, ordered=False), (x,), reps, cache,
              engine="xla", n=n, kind="c2c unordered", direction="fwd")
        timed(rep, f"c2c inv unordered n={n}", S.ifft_unordered, (x,),
              reps, cache, engine="xla", n=n, kind="c2c unordered",
              direction="inv")
        del x
    for n in sizes.real:
        x = make_input(n + 1, (sizes.real_elems // n, n), "f32")
        h = make_input(n + 2, (sizes.real_elems // n, n // 2 + 1), "half")
        for engine in ("jnp", "xla"):
            timed(rep, f"rfft {engine} n={n}",
                  lambda v, e=engine: S.rfft(v, backend=e), (x,), reps,
                  cache, engine=engine, n=n, kind="real", direction="fwd")
            timed(rep, f"irfft {engine} n={n}",
                  lambda v, e=engine, n=n: S.irfft(v, n=n, backend=e),
                  (h,), reps, cache, engine=engine, n=n, kind="real",
                  direction="inv")
        del x, h

    for n in sizes.huge:
        x = make_input(n + 3, (1, n), "c64")
        for engine, fwd, inv in (
                ("jnp full length",
                 lambda v: S.fft_large(v, backend="jnp"),
                 lambda v: S.ifft_large(v, backend="jnp")),
                ("four-step xla rows",
                 lambda v: fourstep.fft_four_step(v, backend="xla"),
                 lambda v: fourstep.fft_four_step(v, inverse=True,
                                                  backend="xla",
                                                  scale=1.0 / v.shape[-1])),
                ("four-step jnp rows",
                 lambda v: fourstep.fft_four_step(v, backend="jnp"),
                 lambda v: fourstep.fft_four_step(v, inverse=True,
                                                  backend="jnp",
                                                  scale=1.0 / v.shape[-1]))):
            timed(rep, f"fft_large {engine} n={n}", fwd, (x,), reps, cache,
                  engine=engine, n=n, kind="huge c2c", direction="fwd")
            timed(rep, f"ifft_large {engine} n={n}", inv, (x,), reps, cache,
                  engine=engine, n=n, kind="huge c2c", direction="inv")
        del x
        r = make_input(n + 4, (1, n), "f32")
        h = make_input(n + 5, (1, n // 2 + 1), "half")
        for engine, fwd, inv in (
                ("jnp full length",
                 lambda v: S.rfft_large(v, backend="jnp"),
                 lambda v, n=n: S.irfft_large(v, n=n, backend="jnp")),
                ("four-step xla rows",
                 lambda v: fourstep.rfft_four_step(v, backend="xla"),
                 lambda v, n=n: fourstep.irfft_four_step(
                     v, n, backend="xla", normalize=True)),
                ("four-step jnp rows",
                 lambda v: fourstep.rfft_four_step(v, backend="jnp"),
                 lambda v, n=n: fourstep.irfft_four_step(
                     v, n, backend="jnp", normalize=True))):
            timed(rep, f"rfft_large {engine} n={n}", fwd, (r,), reps, cache,
                  engine=engine, n=n, kind="huge real", direction="fwd")
            timed(rep, f"irfft_large {engine} n={n}", inv, (h,), reps,
                  cache, engine=engine, n=n, kind="huge real",
                  direction="inv")
        del r, h

    # convolution against one transform on the auto route over as many
    # bytes as the convolution writes (every case writes a full batch)
    n = sizes.conv_n
    nb, m, streams = sizes.bank
    x = make_input(11, (sizes.c2c_elems // n, n), "c64")
    t_fft = timed(rep, f"fft n={n}", S.fft, (x,), reps, cache, n=n,
                  kind="reference")
    t_conv = timed(rep, f"convolve n={n}", S.convolve,
                   (x, make_input(12, (n,), "c64")), reps, cache, n=n,
                   kind="convolve")
    rep.add("ratio", name=f"convolve / fft n={n}", ratio=t_conv / t_fft)
    del x
    t_conv = timed(rep, f"convolve bank n={nb} m={m}", S.convolve,
                   (make_input(13, (sizes.c2c_elems // (m * nb), nb), "c64"),
                    make_input(14, (m, nb), "c64")), reps, cache, n=nb, m=m,
                   kind="convolve bank")
    rep.add("ratio", name=f"convolve bank / fft n={n}", ratio=t_conv / t_fft)
    x = make_input(15, (sizes.real_elems // n, n), "f32")
    t_fft = timed(rep, f"rfft n={n}", S.rfft, (x,), reps, cache, n=n,
                  kind="reference")
    t_conv = timed(rep, f"convolve_real n={n}", S.convolve_real,
                   (x, make_input(16, (n // 2 + 1,), "half")), reps, cache,
                   n=n, kind="convolve_real")
    rep.add("ratio", name=f"convolve_real / rfft n={n}",
            ratio=t_conv / t_fft)
    del x
    name = f"convolve_real bank n={nb} m={m} streams={streams}"
    t_conv = timed(rep, name, S.convolve_real,
                   (make_input(17, (streams, nb), "f32"),
                    make_input(18, (m, nb // 2 + 1), "half")), reps, cache,
                   n=nb, m=m, streams=streams, kind="convolve_real bank")
    rep.add("ratio", name=f"convolve_real bank / rfft n={n}",
            ratio=t_conv / t_fft)


# ---------------------------------------------------------------------------
# phase 4: gpu-marked tests
# ---------------------------------------------------------------------------


def run_gpu_tests(rep: Report) -> None:
    """``pytest -m gpu`` in this process, so no second process opens the
    card; tests/conftest.py leaves the platform alone when
    SMFFT_TESTS_ON_DEVICE=1."""
    import pytest

    os.environ["SMFFT_TESTS_ON_DEVICE"] = "1"
    rc = pytest.main([str(REPO / "tests"), "-m", "gpu", "-q",
                      "-p", "no:cacheprovider", "-p", "no:randomly"])
    rep.add("tests", selection="-m gpu", exit_code=int(rc), ok=rc == 0)
    if rc != 0:
        raise SmokeFailure(f"gpu-marked tests failed (pytest exit {rc})")


# ---------------------------------------------------------------------------
# --chips 4: the multi-device path only
# ---------------------------------------------------------------------------


def check_multi(rep: Report, devices, sizes: MultiSizes) -> None:
    """distributed_fft / distributed_rfft over a 1-D mesh of the devices
    (all_to_all four-step), sharded_fft and the sharded template-bank
    convolve over the batch — each compared with a single-device
    jnp.fft of the same input, and both timed."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as PSpec

    from smfft.models.real import numpy_to_packed_layout
    from smfft.parallel import (batch_mesh, distributed_fft,
                                distributed_rfft, sharded_convolve,
                                sharded_fft)

    d0 = devices[0]
    fft_mesh = Mesh(np.array(devices), ("fft",))
    mesh = batch_mesh(devices)
    rel_err = jax.jit(lambda a, b: jnp.max(jnp.abs(a - b))
                      / jnp.max(jnp.abs(b)))

    def case(name, multi, single, args, specs, **fields):
        """Time and compare multi (inputs laid out over the mesh by
        ``specs``) against single (inputs on the first device)."""
        multi, single = jax.jit(multi), jax.jit(single)
        spread = [jax.device_put(a, NamedSharding(m_, sp))
                  for a, (m_, sp) in zip(args, specs)]
        t_s, moved, _ = time_call(single, *args, reps=sizes.reps)
        t_m, _, _ = time_call(multi, *spread, reps=sizes.reps)
        want = single(*args)
        got = jax.device_put(multi(*spread), d0)
        del spread
        err = float(rel_err(got, want))
        del got, want
        rep.add("timing", name=name, devices=len(devices), ms=t_m * 1e3,
                gbps=moved / t_m / 1e9, one_device_ms=t_s * 1e3,
                one_device_gbps=moved / t_s / 1e9, card=rep.card, **fields)
        _check(rep, f"{name} vs one-device jnp.fft", err, 1e-5,
               devices=len(devices), metric="max abs err / max abs ref")

    def on_d0(seed, shape, kind):
        return jax.device_put(make_input(seed, shape, kind), d0)

    # the signal arrives in contiguous blocks over the mesh
    vec = [(fft_mesh, PSpec("fft"))]
    rows = [(mesh, PSpec("batch", None))]
    n = sizes.dist_n
    case(f"distributed_fft n={n}", lambda v: distributed_fft(v, fft_mesh),
         jnp.fft.fft, (on_d0(41, (n,), "c64"),), vec, n=n)
    case(f"distributed_rfft n={n}", lambda v: distributed_rfft(v, fft_mesh),
         lambda v: numpy_to_packed_layout(jnp.fft.rfft(v)),
         (on_d0(42, (n,), "f32"),), vec, n=n)
    nb = sizes.batch_n
    case(f"sharded_fft n={nb}", lambda v: sharded_fft(v, mesh), jnp.fft.fft,
         (on_d0(43, (sizes.batch_elems // nb, nb), "c64"),), rows, n=nb)
    nc, m, b = sizes.bank
    case(f"sharded_convolve bank n={nc} m={m}",
         lambda v, f: sharded_convolve(v, f, mesh),
         lambda v, f: jnp.fft.ifft(jnp.fft.fft(v)[None] * f[:, None]),
         (on_d0(44, (b, nc), "c64"), on_d0(45, (m, nc), "c64")),
         rows + [(mesh, PSpec(None, None))], n=nc, m=m)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def run(chips: int) -> dict:
    """All phases for ``chips`` (1 or 4); returns the contract's device
    record.  Raises SmokeFailure (or any error) at the first failure."""
    from smfft.utils import compile_cache

    compile_cache.enable()
    import jax

    devices = require_gpus(chips)
    card = card_description()
    rep = Report(card)
    rep.add("device", card=card, platform=devices[0].platform,
            device_kind=devices[0].device_kind, count=len(jax.devices()),
            jax=jax.__version__)
    ok = False
    try:
        if chips == 4:
            check_multi(rep, devices, full_multi_sizes())
        else:
            sizes, cache = full_sizes(), {}
            check_c2c(rep, sizes, cache)
            check_real(rep, sizes, cache)
            check_convolve(rep, sizes, cache)
            check_huge(rep, sizes, cache)
            check_planar(rep, sizes)
            time_routes(rep, sizes, cache)
            cache.clear()
            run_gpu_tests(rep)
        ok = True
    finally:
        rep.write(REPORT, ok)
    print(f"card: {card}")
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chips", type=int, choices=(1, 4), default=1,
                   help="4: run only the four-device path")
    args = p.parse_args(argv)
    try:
        device = run(args.chips)
    except ModuleNotFoundError as e:
        print(f"chip_smoke: {e}; run it from the smfft repository root",
              file=sys.stderr)
        return 2
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
