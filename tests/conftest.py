"""Test harness: the suite runs on the CPU with 8 virtual devices so the
sharding tests have a mesh (SURVEY §4: the reference's CPU-vs-GPU cross-check
pattern maps to jit-vs-sharded consistency tests here).

Tests that need the GPU carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them where JAX finds no GPU.  Run them on the card
with ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``."""

import os

import pytest

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX finds none."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (JAX backend is "
                    f"{jax.default_backend()})")
    return jax.devices()[0]
