"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-device SPMD code is tested without accelerators via XLA's host
platform device forcing — the standard JAX trick (SURVEY.md §4). The
platform is pinned to the CPU unless ``JAX_PLATFORMS`` names another one
or a backend is already up: then the tests run where that process runs
(``chip_smoke.py`` runs the ``gpu``-marked tests inside its own process
on the card).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
from jax._src import xla_bridge  # noqa: E402

if (os.environ.get("JAX_PLATFORMS", "cpu") in ("", "cpu")
        and not xla_bridge.backends_are_initialized()):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

from vision_transformer_detector.utils.runtime import (  # noqa: E402
    enable_compilation_cache)

enable_compilation_cache()


import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked ``gpu`` need a GPU backend; elsewhere they skip.
    Decided here, at run time, never while modules are imported."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip("needs a GPU; chip_smoke.py runs it on the card")
