"""Test configuration: force CPU with a virtual 8-device mesh.

Multi-chip sharding tests run on a fake 8-device CPU backend — the mechanism
the reference repo lacks entirely (it has no distributed tests; see SURVEY.md
section 4).

Note: a pytest plugin imports jax before this conftest runs, so env vars
(JAX_PLATFORMS / XLA_FLAGS) are read too late — use jax.config.update, which
works any time before backend initialization.
"""

import os

# hermetic tests: never touch the persistent compile cache (CPU AOT cache
# writes segfaulted the suite in this container; loads risk SIGILL across
# machine types — see utils/cache.py)
os.environ["FDTD2D_CACHE_DIR"] = "0"

import jax

# Allow float64 oracles on CPU; runtime code is dtype-explicit (float32 on the GPU).
jax.config.update("jax_enable_x64", True)

# FDTD2D_TEST_GPU=1 leaves the platform alone, for the `gpu`-marked tests
# on the card (README, Quick start); every other run is the CPU mesh.
if os.environ.get("FDTD2D_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    assert jax.default_backend() == "cpu", "tests must run on the CPU backend"
    assert len(jax.devices()) == 8
