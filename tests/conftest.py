"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

Tests never require a GPU; multi-device sharding is validated on the
standard XLA host-platform simulation (SURVEY §4's fake-backend strategy).
Must run before jax is imported anywhere.  Tests marked ``gpu`` take the
``gpu`` fixture, which skips them when no card is present.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import pathlib
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


@pytest.fixture
def gpu():
    """Skip unless JAX sees a GPU (decided per test, never at import)."""
    import jax

    try:
        found = jax.devices("gpu")
    except RuntimeError:
        found = []
    if not found:
        pytest.skip("needs an NVIDIA GPU")
    return found[0]
