"""Test harness: a deterministic CPU JAX backend with 8 virtual devices, so
multi-device sharding tests run without accelerators.

``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`` runs the tests marked
``gpu`` on an NVIDIA GPU instead; everywhere else they skip (``gpu_device``).
"""

import os
import sys

import pytest

ON_GPU = os.environ.get("JAX_PLATFORMS", "") in ("cuda", "gpu")

flags = os.environ.get("XLA_FLAGS", "")
if not ON_GPU and "xla_force_host_platform_device_count" not in flags:
    flags += " --xla_force_host_platform_device_count=8"
# SSE4.2 has no FMA instructions, so XLA:CPU rounds every mul/add separately,
# exactly like numpy — required for bitwise device-vs-oracle parity tests.
# (XLA:GPU gets the same from ash_renderer.backend.NO_FMA_FLAG.)
if "xla_cpu_max_isa" not in flags:
    flags += " --xla_cpu_max_isa=SSE4_2"
os.environ["XLA_FLAGS"] = flags.strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import ash_renderer  # noqa: E402,F401  (sets the XLA flags before JAX starts)
import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: decided at run time, never at import."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip(
            "needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m pytest "
            "tests/ -m gpu"
        )
    return gpus[0]
