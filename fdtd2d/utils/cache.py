"""Persistent XLA compilation cache wiring.

First compiles of the large FDFD and training programs take seconds to
minutes, and every fresh process pays them again. JAX can keep compiled
executables on disk keyed by the program's hash; every process-level entry
point (CLI, bench, chip_smoke, examples) calls
:func:`enable_compilation_cache` before building programs.

Where the cache lives:

- ``$JAX_COMPILATION_CACHE_DIR`` when it is set. JAX reads the variable
  itself, so no directory is set in code then.
- Otherwise ``<checkout>/.cache/xla``: one fixed path inside the checkout
  (git-ignored), so that the processes of one run, and later runs from the
  same checkout, find each other's entries. The path is part of the key.

``FDTD2D_CACHE_DIR=0`` turns the default off (the tests do).
"""

from __future__ import annotations

import os

CACHE_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".cache")
DEFAULT_DIR = os.path.join(CACHE_ROOT, "xla")


def resolve_cache_dir(environ=os.environ) -> str | None:
    """The directory the cache goes to, or None when it is off."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return environ["JAX_COMPILATION_CACHE_DIR"]
    if environ.get("FDTD2D_CACHE_DIR") == "0":
        return None
    return DEFAULT_DIR


def enable_compilation_cache() -> str | None:
    """Turn the persistent cache on; returns the directory used (or None)."""
    path = resolve_cache_dir()
    if path is None:
        return None

    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        if jax.default_backend() == "cpu":
            # XLA:CPU serializes machine-specific AOT executables whose loads
            # on another machine warn of SIGILL, and a cache write crashed a
            # full test run here: on the CPU the cache is opt-in through
            # JAX_COMPILATION_CACHE_DIR only.
            return None
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # cache every compile over half a second: a fresh process otherwise
    # recompiles each of the many mid-sized solver programs it runs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
