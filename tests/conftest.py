"""Test harness config: CPU backend with 8 virtual devices for mesh tests.

The flags must be set before jax initializes a backend, so they are set here,
before anything imports the package (which configures JAX on import).
"""

import os

# The unit tests run on the deterministic 8-virtual-device CPU backend, also
# on a machine with a GPU.  The GPU path runs through chip_smoke.py.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import plonky2_ecdsa  # noqa: E402,F401  (persistent compile cache + x64 setup)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0xECD5A)
