"""Test configuration: run everything on CPU with 8 virtual devices so
multi-card sharding paths compile and execute without accelerator hardware
(SURVEY.md section 4: xla_force_host_platform_device_count).

Tests marked ``gpu`` need a real GPU; the ``gpu_device`` fixture skips them
on the CPU (run them on the card with ``HEVCASM_TEST_GPU=1``)."""

import os

# Force CPU unless the card tests are asked for: unit tests must be
# hermetic and run the 8-virtual-device mesh.
_GPU_RUN = os.environ.get("HEVCASM_TEST_GPU") == "1"
if not _GPU_RUN:
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if not _GPU_RUN:
    # Set the config too, in case a backend was configured before
    # conftest ran.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0x48455643)  # "HEVC"


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when none is present (decided at run time,
    never at import, so every xdist worker collects the same tests)."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs a GPU (run with HEVCASM_TEST_GPU=1 on the card)")
    return devices[0]
