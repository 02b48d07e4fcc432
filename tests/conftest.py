"""Test settings.

Plain ``pytest`` runs on the CPU backend with 8 virtual devices, so the
sharded paths run on a mesh without a GPU; the device coder then takes its
plain-XLA route (ops/route.py).  Tests of what runs only on an NVIDIA GPU
(the CUDA kernels) carry the ``gpu`` marker and take the ``gpu`` fixture,
which skips unless JAX's default device is a GPU; ``python chip_smoke.py``
runs them on the card in its own process.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

try:
    jax.config.update("jax_num_cpu_devices", 8)
except Exception:  # pragma: no cover - backend already initialized
    pass


@pytest.fixture
def gpu():
    """The default device, when it is an NVIDIA GPU; skip otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card by chip_smoke.py)")
    return dev
