#!/usr/bin/env python
"""Matched-filter detection pipeline on the template-bank convolution.

The reference library exists to feed exactly this shape of pipeline
(reference README.md:10 — shared-memory FFTs for convolution; its home
project Astro-Accelerate searches pulsar surveys by correlating
dedispersed streams against template banks).  This example runs the
whole loop end to end:

  1. simulate noisy streams with pulse templates embedded at random
     offsets,
  2. correlate every stream against the whole template bank with ONE
     call (r2c computed once per signal, shared across the bank —
     ``smfft.api.convolve_real`` bank mode),
  3. detect: z-scored peak over the correlation lag surface.

Run:  python examples/matched_filter.py [--streams 64] [--selfcheck]
on whatever device JAX finds (the CPU included).
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, ".")


def make_templates(m, k, rng):
    """Gaussian-envelope chirps with distinct chirp rates, unit energy."""
    t = np.linspace(-1.0, 1.0, k)
    rates = np.linspace(4.0, 14.0, m)
    bank = np.stack([np.exp(-4.0 * t ** 2) * np.cos(2 * np.pi * r * t ** 2)
                     for r in rates])
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    return bank.astype(np.float32)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--streams", type=int, default=64)
    p.add_argument("--length", type=int, default=4096)
    p.add_argument("--templates", type=int, default=8)
    p.add_argument("--klen", type=int, default=256)
    p.add_argument("--snr", type=float, default=0.6)
    p.add_argument("--selfcheck", action="store_true",
                   help="verify detections against the planted truth")
    args = p.parse_args(argv)

    import jax.numpy as jnp
    from smfft import api

    rng = np.random.default_rng(7)
    b, t, m, k = args.streams, args.length, args.templates, args.klen
    n = t  # one circular frame per stream (t a supported size)

    bank = make_templates(m, k, rng)
    truth_tpl = rng.integers(0, m, b)
    truth_off = rng.integers(0, t - k, b)
    x = (rng.standard_normal((b, t)) / np.sqrt(k)).astype(np.float32)
    for i in range(b):
        x[i, truth_off[i]:truth_off[i] + k] += (
            args.snr * bank[truth_tpl[i]])

    # frequency responses of the time-REVERSED templates: circular
    # convolution with h[::-1] is cross-correlation (matched filtering)
    taps = np.zeros((m, n), np.float32)
    taps[:, :k] = bank[:, ::-1]
    hf = api.rfft(jnp.asarray(taps))            # (m, n/2+1), one-time

    # the hot loop: every stream against every template in one call —
    # each signal's r2c is computed once for the whole bank
    corr = api.convolve_real(jnp.asarray(x), hf)          # (m, b, n)

    lags = np.asarray(corr)[:, :, k - 1:t]      # valid cross-corr lags
    flat = lags.reshape(m, b, -1)
    scores = (flat - flat.mean(-1, keepdims=True)) / flat.std(-1, keepdims=True)
    best = scores.reshape(m, b, -1).max(-1)     # (m, b) peak z per pair
    det_tpl = best.argmax(0)                    # template id per stream
    det_off = np.array([flat[det_tpl[i], i].argmax() for i in range(b)])
    det_z = best.max(0)

    hits = np.sum((det_tpl == truth_tpl) & (np.abs(det_off - truth_off) <= 1))
    print(f"streams={b} templates={m} length={t} K={k} snr={args.snr}")
    print(f"detected {hits}/{b} planted pulses "
          f"(median peak z = {np.median(det_z):.1f})")
    for i in range(min(b, 5)):
        mark = "ok " if (det_tpl[i] == truth_tpl[i]
                         and abs(det_off[i] - truth_off[i]) <= 1) else "MISS"
        print(f"  stream {i:3d}: template {det_tpl[i]} @ lag {det_off[i]:5d} "
              f"z={det_z[i]:5.1f}  (truth: {truth_tpl[i]} @ "
              f"{truth_off[i]:5d})  {mark}")
    if args.selfcheck:
        assert hits >= int(0.9 * b), f"only {hits}/{b} detected"
        print("SELFCHECK PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
