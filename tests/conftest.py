"""Test harness config.

The suite runs on the CPU unless `JAX_PLATFORMS` names another platform;
the CPU backend gets 8 virtual devices for the multi-device sharding tests
(SURVEY.md §4 item 5). Tests that need the card carry the `gpu` marker and
take the `gpu` fixture, which skips them unless JAX's default backend is a
GPU; run them on the card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

XLA_FLAGS is read when the first backend client is created, which has not
happened yet when pytest imports this file.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

from physics_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
enable_compile_cache()


@pytest.fixture
def gpu():
    """Skip unless the default JAX backend is a GPU (decided here, at run
    time — never while test modules are imported)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend (JAX_PLATFORMS=cuda)")
