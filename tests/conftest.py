"""Test configuration: hermetic CPU JAX with an 8-device virtual mesh.

Must run before any jax import. The device engine runs its plain-JAX twin
on the CPU; tests that need an NVIDIA GPU carry the ``gpu`` marker and skip
here (chip_smoke.py runs the same checks on the card).
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# persistent XLA compile cache (JAX_COMPILATION_CACHE_DIR, else the fixed
# in-checkout directory): the scan steps recompile identically in every
# pytest worker otherwise
from npore_tpu.paths import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

DATA = os.path.join(REPO, "tests", "data")
STATS = os.path.join(REPO, "guppy5_stats")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def data_dir():
    return DATA


@pytest.fixture(scope="session")
def stats_dir():
    return STATS


@pytest.fixture(scope="session")
def score_matrices():
    from npore_tpu.model.scores import (calc_score_matrices,
                                        load_confusion_matrices)
    subs, nps, inss, dels = load_confusion_matrices(STATS)
    return calc_score_matrices(subs, nps, inss, dels)


@pytest.fixture
def gpu():
    """Skip unless JAX finds an NVIDIA GPU (decided when the test runs,
    never at import or collection)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs this there)")
    return jax.devices()[0]
