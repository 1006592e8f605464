"""Test configuration: force CPU with 8 virtual devices (sharding tests) and f64.

XLA_FLAGS is read lazily at the first backend init, and the platform is
pinned through jax.config before any backend is instantiated.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session", autouse=True)
def _check_cpu():
    assert jax.devices()[0].platform == "cpu"
    assert len(jax.devices()) == 8
