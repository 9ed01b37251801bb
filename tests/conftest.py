"""Test env: the CPU backend with 8 virtual devices for the multi-device
tests, unless JAX_PLATFORMS names another platform.

Must run before the first `import jax` anywhere in the test session.
Tests marked `gpu` run only where JAX's default device is a GPU:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def fresh_transform_registry():
    """Isolate the global transform registry between tests."""
    from flexlight_tpu.scene.transform import reset_global_registry

    reset_global_registry()
    yield
    reset_global_registry()


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests unless JAX's default device is a GPU
    (decided here, per test, never at import)."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        platform = jax.devices()[0].platform
        if platform != "gpu":
            pytest.skip(f"needs a GPU; default device is {platform!r}")
