"""chip_smoke.py on the CPU: it refuses to run without a GPU, and each of
its phases runs end to end at tiny sizes."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke as C  # noqa: E402

TINY = C.Sizes(c2c=(32, 256), real=(64, 256), c2c_elems=1 << 12,
               real_elems=1 << 13, huge=(1 << 15,), bank=(256, 2, 8),
               conv_n=256, any_n=100, reps=1)


def _run_script(cwd):
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", str(cwd)),
           "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, env=env,
                          timeout=300)


def _json_lines(stdout):
    out = []
    for line in stdout.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            pass
    return out


def test_cpu_run_exits_nonzero_without_result():
    r = _run_script(REPO)
    assert r.returncode != 0
    assert not _json_lines(r.stdout)
    assert "needs an NVIDIA GPU" in r.stderr


def test_bare_directory_exits_nonzero(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_script(tmp_path)
    assert r.returncode != 0
    assert not _json_lines(r.stdout)


def test_require_gpus_refuses_cpu():
    with pytest.raises(C.SmokeFailure, match="no CPU fallback"):
        C.require_gpus()


def test_main_prints_contract_line_last(monkeypatch, capsys):
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
              "count": 1}
    monkeypatch.setattr(C, "run", lambda chips: device)
    assert C.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": device}


def test_main_failure_prints_no_result(monkeypatch, capsys):
    def fail(chips):
        raise C.SmokeFailure("phase 2 failed")
    monkeypatch.setattr(C, "run", fail)
    assert C.main(["--chips", "4"]) == 1
    assert not _json_lines(capsys.readouterr().out)


def test_check_raises_over_bound():
    rep = C.Report()
    C._check(rep, "within", 1e-6, 1e-5)
    C._check(rep, "printed", 1.0, None)
    with pytest.raises(C.SmokeFailure, match="over"):
        C._check(rep, "over", 1e-4, 1e-5)
    assert [e["ok"] for e in rep.entries] == [True, True, False]


def test_report_written(tmp_path):
    rep = C.Report("card, 700.00 W")
    rep.add("timing", name="x", ms=1.0)
    rep.write(tmp_path / "r.json", ok=True)
    data = json.loads((tmp_path / "r.json").read_text())
    assert data["ok"] and data["card"] == "card, 700.00 W"
    assert data["entries"][0]["name"] == "x"


def test_make_input_half_spectrum_edges_real():
    h = np.asarray(C.make_input(3, (4, 9), "half"))
    assert np.all(h[:, 0].imag == 0) and np.all(h[:, -1].imag == 0)
    assert np.all(np.abs(h.real) <= 1) and np.any(h[:, 1:-1].imag != 0)


@pytest.mark.parametrize("phase", ["check_c2c", "check_real",
                                   "check_convolve", "check_huge",
                                   "time_routes"])
def test_phase_runs_tiny(phase):
    rep = C.Report("cpu")
    getattr(C, phase)(rep, TINY, {})
    assert rep.entries
    assert all(e.get("ok", True) for e in rep.entries)


@pytest.mark.parametrize("one_call_s, out_bytes, calls", [
    (0.2e-3, 1 << 27, 16),          # 2**24 complex at 0.2 ms: queue-bound
    (0.2e-3, 1 << 20, 100),         # short and small: fills the window
    (3e-3, 1 << 30, 2),             # 2**27 complex at 3 ms
    (3e-3, 4 << 30, 1),             # a 4 GiB output: one call per window
    (0.05, 1 << 10, 1),             # longer than the window
])
def test_calls_per_window(one_call_s, out_bytes, calls):
    assert C.calls_per_window(one_call_s, out_bytes) == calls


def test_time_call_counts_bytes_and_calls():
    x = jax.numpy.ones((64, 32), jax.numpy.complex64)
    secs, moved, calls = C.time_call(jax.jit(lambda v: v * 2), x, reps=2)
    assert secs > 0 and moved == 2 * x.nbytes and calls >= 1


def test_time_routes_times_unordered_pair():
    rep = C.Report("cpu")
    C.time_routes(rep, TINY, {})
    timings = {e["name"]: e for e in rep.entries if e["tag"] == "timing"}
    for n in TINY.c2c:
        for name in (f"fft_unordered n={n}", f"c2c inv unordered n={n}",
                     f"fft xla highest n={n}", f"c2c fwd jnp n={n}"):
            assert timings[name]["ms"] > 0
            assert timings[name]["calls_per_window"] >= 1


def test_planar_phase_runs_tiny():
    rep = C.Report("cpu")
    C.check_planar(rep, TINY)
    names = {e["name"] for e in rep.entries if e["tag"] == "check"}
    assert {"planar.fft n=256", "planar.fft_any n=100",
            "planar.irfft_large n=32768"} <= names


def test_multi_device_path_tiny():
    rep = C.Report("cpu")
    C.check_multi(rep, jax.devices()[:4],
                  C.MultiSizes(dist_n=1 << 12, batch_n=256,
                               batch_elems=1 << 12, bank=(256, 2, 8),
                               reps=1))
    checks = [e for e in rep.entries if e["tag"] == "check"]
    assert len(checks) == 4 and all(e["ok"] for e in checks)
