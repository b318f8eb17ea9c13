"""Test configuration.

By default everything runs on the CPU with 8 virtual devices: the
multi-device tests use an 8-device host-platform mesh
(xla_force_host_platform_device_count).  The platform is forced through
jax.config, so it holds whatever the environment says.

chip_smoke.py runs the ``gpu``-marked tests inside its own process on the
card and sets SMFFT_TESTS_ON_DEVICE=1 first, so that this file leaves the
platform alone; which tests are collected does not change.  Tests that
need the card take the ``gpu_device`` fixture, which skips them anywhere
else.
"""

import os

if os.environ.get("SMFFT_TESTS_ON_DEVICE") != "1":
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test on any other platform."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the gpu-marked "
                    "tests on the card")
    return jax.devices()[0]


def max_abs_err(a, b):
    return float(np.max(np.abs(np.asarray(a, dtype=np.complex128)
                               - np.asarray(b, dtype=np.complex128))))
