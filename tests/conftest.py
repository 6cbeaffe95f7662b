"""Test configuration.

Tests run on CPU jax with 8 virtual devices, so the sharding tests
exercise a real multi-device mesh without a GPU.  This must run before
jax is imported anywhere.  A run that names another platform in
``JAX_PLATFORMS`` (the chip-marked tests on the card:
``JAX_PLATFORMS=cuda python -m pytest tests -m chip``) keeps it.
"""

import os

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
# persistent compilation cache keeps repeat runs fast
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR", os.path.join(os.path.dirname(__file__), ".jax_cache")
)

import pathlib

import jax
import pytest


@pytest.fixture(scope="session")
def reference_data():
    """Golden assets from a checkout of the reference project
    (``tests_torch/data``), named by ``NR_REFERENCE_DATA``.  Skip when
    it is not given."""
    path = os.environ.get("NR_REFERENCE_DATA")
    if not path or not pathlib.Path(path).exists():
        pytest.skip(
            "reference golden data not available "
            "(set NR_REFERENCE_DATA to the reference's tests_torch/data)"
        )
    return pathlib.Path(path)


@pytest.fixture
def chip():
    """For tests marked ``chip``: they compile for the GPU, so they skip
    on any other platform."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (platform is %s)" % jax.default_backend())


@pytest.fixture(scope="session")
def knot():
    """The generated 2,464-face torus knot (utils/scenes.py)."""
    from neural_renderer_v2_jax.utils.scenes import torus_knot

    return torus_knot(seed=0)
