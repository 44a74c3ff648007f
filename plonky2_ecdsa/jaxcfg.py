"""JAX runtime configuration: persistent compilation cache and the
Goldilocks interior arithmetic.

The prover's jitted pipeline is a large XLA module; its first compile takes
minutes.  The persistent compilation cache lets every later process with the
same program (tests, bench, smoke runs) load it from disk instead.  The cache
lives in ``JAX_COMPILATION_CACHE_DIR`` when that is set, and otherwise in one
fixed directory inside the checkout (``.jax_cache/``, git-ignored): the path
is part of the cache key, so it never depends on a temporary name, a pid or
the time.  Disable the cache with PLONKY2_NO_CACHE=1.

``configure()`` runs once, when the package is imported, so x64 mode is set
before any array exists or any jit traces.
"""

from __future__ import annotations

import os

_DONE = False

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")

# Goldilocks interior per JAX platform.  "u64": native uint64 lanes under
# jax_enable_x64 (3-6x fewer primitives per field op than the u32 pair, so a
# shorter compile).  Both the CPU and the GPU have native 64-bit integer ops
# (the GPU a 32x32->64 multiply).  "u32": the (lo, hi) u32-pair formulation.
FIELD_INTERIOR = {"cpu": "u64", "gpu": "u64"}


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def field_interior(platform: str) -> str:
    """The Goldilocks interior ("u64" or "u32") used on a JAX platform."""
    try:
        return FIELD_INTERIOR[platform]
    except KeyError:
        raise RuntimeError(
            f"no Goldilocks interior is chosen for JAX platform {platform!r} "
            f"(known: {sorted(FIELD_INTERIOR)})") from None


def configure():
    """Idempotent: field interior for the default backend, then the cache."""
    global _DONE
    if _DONE:
        return
    _DONE = True
    setup_field_interior()
    if os.environ.get("PLONKY2_NO_CACHE") == "1":
        return
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


def setup_field_interior():
    """Switch the jax.numpy Goldilocks path to the default backend's interior
    (FIELD_INTERIOR).  PLONKY2_FORCE_U32=1 keeps the u32 pair everywhere."""
    if os.environ.get("PLONKY2_FORCE_U32") == "1":
        return
    import jax

    if field_interior(jax.default_backend()) == "u64":
        jax.config.update("jax_enable_x64", True)
        from .fields import goldilocks as gl

        gl.enable_jax_u64(True)
