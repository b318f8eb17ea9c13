#!/usr/bin/env python
"""Golden-reference verification harness — the reference's L4 main().

Usage (mirrors the reference CLIs):
  python verify.py <FFT_size> <nFFTs> <nRuns> [inverse] [reorder]
                   [--kind c2c|r2c|c2r] [--backend auto|jnp|xla|spec]
                   [--seed S] [--two-tone] [--tolerance T]

Positional args follow SMFFT_CooleyTukey_C2C/FFT.c:84-92
(`FFT_size nFFTs nRuns inverse reorder`); the Stockham variants' 3-arg form
works too.  Each run generates seeded input (deterministic — the reference
seeds with time(NULL), FFT.c:139; we fix that per SURVEY.md §4), computes
the numpy.fft golden spectrum in float64, executes the transform on the
default JAX device, compares with the reference's hybrid error metric and
tolerance (1e-4, FFT.c:12) via the native C harness, and prints timing
(host clock around ``block_until_ready``, compile excluded) plus an ANSI
green PASSED / red FAILED verdict (FFT.c:158-159).

nFFTs is taken as given: no engine here packs rows, so the reference's
round-up to its packing multiple (FFT.c:105-116) does not apply.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

GREEN, RED, RESET = "\033[1;32m", "\033[1;31m", "\033[0m"


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("fft_size", type=int)
    p.add_argument("n_ffts", type=int)
    p.add_argument("n_runs", type=int, nargs="?", default=1)
    p.add_argument("inverse", type=int, nargs="?", default=0)
    p.add_argument("reorder", type=int, nargs="?", default=1)
    p.add_argument("--kind", choices=["c2c", "r2c", "c2r"], default="c2c")
    p.add_argument("--backend", default="auto")
    p.add_argument("--precision", default="highest")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--two-tone", action="store_true",
                   help="two-tone fixture instead of uniform noise")
    p.add_argument("--tolerance", type=float, default=1e-4,
                   help="reference max_error (FFT.c:12)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from smfft.utils.compile_cache import enable as _enable_cache
    _enable_cache()
    import jax
    import jax.numpy as jnp
    from smfft import api, native
    from smfft.config import flags
    from smfft.ops import matmul_fft

    n, n_ffts = args.fft_size, args.n_ffts
    print(f"device: {jax.devices()[0].device_kind} "
          f"({jax.default_backend()}), kind={args.kind}, N={n}, "
          f"nFFTs={n_ffts}, runs={args.n_runs}, inverse={args.inverse}, "
          f"reorder={args.reorder}, backend={args.backend}")

    def timed_runs(fn, *inputs):
        """Warm up (compile, untimed — the reference times kernels only,
        FFT-GPU-32bit.cu:868-869), then time n_runs with the host clock
        around block_until_ready."""
        jax.block_until_ready(fn(*inputs))
        times, out = [], None
        for _ in range(args.n_runs):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(*inputs))
            times.append(time.perf_counter() - t0)
        return out, times

    if args.kind == "c2c":
        if args.two_tone:
            re = native.generate_two_tone(n_ffts, n)
            im = np.zeros_like(re)
        else:
            re = native.generate_uniform(n_ffts * n, args.seed).reshape(
                n_ffts, n)
            im = native.generate_uniform(n_ffts * n, args.seed + 1).reshape(
                n_ffts, n)
        x = (re + 1j * im).astype(np.complex64)
        golden = (np.fft.ifft(x.astype(np.complex128)) * n if args.inverse
                  else np.fft.fft(x.astype(np.complex128)))

        xd = jnp.asarray(x)
        import functools
        kw = dict(ordered=bool(args.reorder), backend=args.backend,
                  precision=args.precision)
        if args.inverse:
            kw["norm"] = None  # reference contract: unnormalized
        fn = jax.jit(functools.partial(
            api.ifft if args.inverse else api.fft, **kw))
        out, times = timed_runs(fn, xd)
        got = np.asarray(out)
        if not args.reorder:
            # unordered output is a backend-defined fixed permutation; the
            # reference skips verification here (FFT.c:161-163) — we
            # un-permute per backend and verify anyway.
            if api._resolve_backend(args.backend, ordered=False) == "spec":
                from smfft.models import cooley_tukey
                got = got[:, cooley_tukey.bit_reverse_indices(n)]
            else:
                from smfft import params as _P
                perm = matmul_fft.digit_reverse_indices(
                    n, _P.get_factorization(n))
                got = got[:, perm]
        stats = (native.compare(got, golden.astype(np.complex64),
                                args.tolerance) if flags.testing else None)
    elif args.kind == "r2c":
        x = native.generate_uniform(n_ffts * n, args.seed).reshape(n_ffts, n)
        golden = np.fft.rfft(x.astype(np.float64)).astype(np.complex64)
        xd = jnp.array(x)
        import functools
        packed_real = jax.jit(functools.partial(
            api.fft_packed_real, backend=args.backend,
            precision=args.precision))
        out, times = timed_runs(packed_real, xd)
        got = np.asarray(out)
        stats = (native.compare_r2c_packed(got, golden, args.tolerance)
                 if flags.testing else None)
    else:  # c2r
        xsig = native.generate_uniform(n_ffts * n, args.seed).reshape(
            n_ffts, n)
        spec = np.fft.rfft(xsig.astype(np.float64)).astype(np.complex64)
        golden = xsig  # unnormalized output compares at scale N/2
        sd = jnp.asarray(spec)
        import functools
        irfft = jax.jit(functools.partial(
            api.irfft, n=n, backend=args.backend,
            precision=args.precision, norm=None))
        out, times = timed_runs(irfft, sd)
        got = np.asarray(out)
        stats = (native.compare_real(got, golden, got_scale=n // 2,
                                     want_scale=1.0,
                                     tolerance=args.tolerance)
                 if flags.testing else None)

    mean_ms = 1e3 * float(np.mean(times))
    print(f"smfft time: {mean_ms:.3f} ms/run (mean of {args.n_runs}; "
          f"host clock, includes dispatch) on {jax.devices()[0].platform} "
          f"{jax.devices()[0].device_kind}")
    if stats is None:
        # reference behavior with TESTING off: timing only, no golden
        # compare (SMFFT_Stockham_C2C/FFT.c:138-144, debug.h:3)
        print("no verification (SMFFT_TESTING=0)")
        return 0
    print(f"total error: {stats['total_error']:.6e}  "
          f"mean error: {stats['mean_error']:.6e}  "
          f"max error: {stats['max_error']:.6e}")
    ok = stats["error_count"] == 0
    verdict = f"{GREEN}PASSED{RESET}" if ok else (
        f"{RED}FAILED{RESET} ({stats['error_count']} elements over "
        f"tolerance {args.tolerance})")
    print(verdict)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
