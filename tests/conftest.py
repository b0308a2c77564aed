"""Test configuration: force a virtual 8-device CPU mesh.

Backend initialization is lazy, so setting the platform before the
first device query keeps every test on the local CPU backend (with 8
virtual devices for the sharding tests), exercising the same traced
programs that run on the GPU.  Tests that need the card carry the
``gpu`` marker and skip here; ``python chip_smoke.py`` runs their
checks on the card.
"""

import os

# must precede first backend initialization (CPU client reads XLA_FLAGS then)
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def rng(request):
    # function-scoped + name-seeded (stable crc32, not PYTHONHASHSEED-
    # randomized hash): inputs are independent of which other tests run
    # (a shared session stream made tolerances order-dependent)
    import zlib
    seed = zlib.crc32(request.node.name.encode())
    return np.random.default_rng(20260817 + seed)


@pytest.fixture()
def gpu():
    """Skips a test that needs a CUDA GPU (tests carrying the ``gpu``
    marker); ``python chip_smoke.py`` runs those checks on the card."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU; python chip_smoke.py runs this "
                    "check on the card")


@pytest.fixture()
def pallas_interpret(monkeypatch):
    """Route the model's Pallas carbonate kernel through the Pallas
    interpreter, the only way it runs on the CPU."""
    import functools

    from ocean_bgc.ops import pallas_carbonate
    monkeypatch.setattr(
        pallas_carbonate, "co3_terms_dual_sat_pallas",
        functools.partial(pallas_carbonate.co3_terms_dual_sat_pallas,
                          interpret=True))
