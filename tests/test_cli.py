"""CLI harness tests: verify.py end-to-end on CPU (xla backend), the
config contract and the driver entry points."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def run_verify(*args):
    return subprocess.run(
        [sys.executable, str(REPO / "verify.py"), *args],
        capture_output=True, text=True, cwd=REPO,
        env={"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
             "JAX_PLATFORMS": "cpu",
             "HOME": os.environ.get("HOME", str(REPO))})


def test_verify_c2c_passes():
    r = run_verify("256", "64", "1", "0", "1", "--backend", "xla")
    assert "PASSED" in r.stdout, r.stdout + r.stderr
    assert r.returncode == 0


def test_verify_c2c_inverse_noreorder():
    r = run_verify("256", "64", "1", "1", "0", "--backend", "xla")
    assert "PASSED" in r.stdout, r.stdout + r.stderr


def test_verify_rounds_up_n32():
    """nFFTs at N=32 is taken as given: no engine packs rows, so the
    reference's round-up (FFT.c:105-116) is not applied."""
    r = run_verify("32", "30", "1", "0", "1", "--backend", "xla")
    assert "rounded up" not in r.stdout
    assert "nFFTs=30," in r.stdout
    assert "PASSED" in r.stdout, r.stdout + r.stderr


def test_verify_r2c_c2r():
    r = run_verify("512", "32", "1", "--kind", "r2c", "--backend", "xla")
    assert "PASSED" in r.stdout, r.stdout + r.stderr
    r = run_verify("512", "32", "1", "--kind", "c2r", "--backend", "xla")
    assert "PASSED" in r.stdout, r.stdout + r.stderr


def test_verify_two_tone():
    r = run_verify("256", "16", "1", "--two-tone", "--backend", "xla")
    assert "PASSED" in r.stdout, r.stdout + r.stderr


def test_verify_detects_wrong_size():
    r = run_verify("100", "16", "1")
    assert r.returncode != 0


def test_config_flags_defaults():
    from smfft import config
    assert config.flags.testing is True
    assert config.flags.precision in ("highest", "default")


def test_graft_entry_importable():
    sys.path.insert(0, str(REPO))
    try:
        import __graft_entry__ as g
        fn, args = g.entry()
        out = fn(*args)
        assert out[0].shape == args[0].shape
    finally:
        sys.path.pop(0)
