"""Test configuration.

The suite runs on the host CPU with 8 virtual devices (for the multi-device
tests) and float64 enabled (the accuracy sweeps go down to ~1e-12 relative
error — the analogue of the reference's Float64 test budgets); the Pallas
kernel runs in the interpreter there.

Tests marked ``gpu`` need a CUDA GPU and skip elsewhere.  ``python
chip_smoke.py`` runs them on a GPU host: it sets ``NUFFT_GPU_TESTS=1``,
which leaves JAX on its default (GPU) platform.

The env vars must be set before JAX is first imported.
"""

import os

_ON_GPU = os.environ.get("NUFFT_GPU_TESTS") == "1"

if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU (run by python chip_smoke.py)"
    )


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests when JAX has no GPU.  Decided per test,
    never at import time, so every worker collects the same tests."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU; run python chip_smoke.py on a GPU host")


@pytest.fixture
def rng():
    return np.random.default_rng(42)
