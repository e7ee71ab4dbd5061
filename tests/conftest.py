"""Test environment: virtual 8-device CPU mesh, f64 enabled.

The reference cannot run its distributed path without an LSF cluster and
Platform MPI (SURVEY.md §4); here every test runs the multi-chip code on a
virtual CPU mesh — the fake-backend capability the reference lacks.
"""

import os

# force CPU: the test suite needs f64 and a virtual 8-device mesh; the
# GPU path is exercised by chip_smoke.py and bench.py instead
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "true")

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest

from tpu80211.datasets import loader


@pytest.fixture(scope="session")
def capture():
    """The frozen parity dataset extracted from the reference tables."""
    return loader.load_capture()
