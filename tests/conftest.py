"""Test configuration: CPU backend with 8 virtual devices.

The tests run on the CPU: sharding tests on a simulated 8-device mesh,
kernel parity tests through XLA's CPU backend. Tests that need a GPU are
marked `gpu`; a fixture decides at run time whether a card is present
and skips them here. `python chip_smoke.py` runs the same checks on the
card.

jax.config pins the platform (backends initialize lazily, so this wins
over whatever JAX_PLATFORMS the environment sets).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: full-size variants (minutes each on CPU); "
        "skipped unless HSPMV_FULL_TESTS=1 or -m slow selects them",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU (skipped on the CPU; chip_smoke.py covers it)",
    )


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests unless the process's devices are GPUs."""
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; run python chip_smoke.py on the card")


def pytest_collection_modifyitems(config, items):
    # Small default variants keep every code path covered in minutes;
    # the full-size versions run with HSPMV_FULL_TESTS=1.
    if os.environ.get("HSPMV_FULL_TESTS") == "1":
        return
    if config.getoption("-m"):
        return  # explicit marker selection wins
    skip = pytest.mark.skip(
        reason="slow full-size variant; set HSPMV_FULL_TESTS=1"
    )
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
