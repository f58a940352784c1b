"""Test configuration: an 8-device virtual CPU mesh, so multi-device
sharding paths are testable without accelerators.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and are skipped
unless JAX's default backend is a GPU.  Run them on the card with the GPU
backend selected explicitly: ``JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/``."""

import os

import pytest

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax  # noqa: E402  (import after env setup)

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)

    assert jax.devices()[0].platform == "cpu", (
        "tests must run on the CPU backend"
    )
    assert len(jax.devices()) == 8, "expected 8 virtual CPU devices"

import jax  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``@pytest.mark.gpu`` tests when no GPU backend is active."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.default_backend() != "gpu":
            pytest.skip("needs an NVIDIA GPU; on the card run "
                        "JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")
