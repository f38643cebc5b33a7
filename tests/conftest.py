"""Test configuration: the tests run on the CPU with 8 virtual devices, so
the sharded step runs on a real mesh without an accelerator.

JAX reads ``JAX_PLATFORMS`` and ``XLA_FLAGS`` when it first initialises its
backends, which happens after this module is imported; setting them here,
before anything imports jax, is enough.
"""

import os
import pathlib
import sys

_DEVICES_FLAG = "--xla_force_host_platform_device_count=8"

os.environ["JAX_PLATFORMS"] = "cpu"
if _DEVICES_FLAG not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               + _DEVICES_FLAG).strip()

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import pytest  # noqa: E402

from pedoni_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

REFERENCE_SCENARIOS = pathlib.Path("/root/reference/scenarios")


@pytest.fixture(scope="session", autouse=True)
def _cpu_mesh():
    assert jax.default_backend() == "cpu", "tests must run on the cpu backend"
    assert len(jax.devices()) == 8, "tests expect 8 virtual CPU devices"


@pytest.fixture
def reference_scenarios() -> pathlib.Path:
    if not REFERENCE_SCENARIOS.is_dir():
        pytest.skip("reference scenarios not available")
    return REFERENCE_SCENARIOS
