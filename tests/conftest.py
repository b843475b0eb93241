"""Test configuration: force a virtual 8-device CPU mesh and f64 support.

Multi-device sharding tests run on jax's host-platform device
virtualization (no accelerator needed); ``python chip_smoke.py`` runs the
device paths on a GPU.  Must run before jax is imported anywhere.
"""

import os

# JAX_PLATFORMS set in the environment would win over in-process
# assignment, so the config.update below is what forces the CPU backend.
os.environ.pop("JAX_PLATFORMS", None)
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from kmer_spans.utils.testgen import golden_genome  # noqa: E402


@pytest.fixture(scope="session")
def golden():
    """The SURVEY.md Appendix-B golden genome (100 kb, 3 planted islands)."""
    return golden_genome()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def random_seq(rng, n, n_prob=0.0, alphabet="ACGT"):
    """Random sequence with optional N runs."""
    chars = rng.choice(list(alphabet), size=n)
    if n_prob > 0:
        mask = rng.random(n) < n_prob
        chars[mask] = "N"
    return "".join(chars)
