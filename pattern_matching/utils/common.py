"""Small shared utilities.

Replacement for the reference's macro layer (common.h:52-55
CEILDIV/ROUNDUP, utils.c:32-54 printable_hex_to_bytes, utils.c:60-68 gettime).
"""

from __future__ import annotations

import os
import time


def cdiv(x: int, y: int) -> int:
    """Ceiling division (reference common.h:52-53 CEILDIV)."""
    return -(-x // y)


def roundup(x: int, y: int) -> int:
    """Round ``x`` up to a multiple of ``y`` (reference common.h:54-55 ROUNDUP)."""
    return cdiv(x, y) * y


def hex_to_bytes(s: str) -> bytes:
    """Decode a printable-hex pattern (no ``0x`` prefix) to raw bytes.

    Reference: utils.c:32-54 printable_hex_to_bytes. Odd-length strings drop
    the trailing nibble (the reference reads pairs and uses strlen/2 bytes).
    """
    s = s.strip()
    if len(s) % 2:
        s = s[:-1]
    return bytes.fromhex(s)


def pad_halo(halo: int, chunk_len: int, block: int = 8) -> int:
    """Pad a halo so (halo + chunk_len) divides the scan engine's unroll
    block — extra halo bytes are harmless (masked by start_t)."""
    return halo + (-(halo + chunk_len)) % block


def now_us() -> int:
    """Wall clock in microseconds (reference utils.c:60-68 gettime)."""
    return time.monotonic_ns() // 1000


CACHE_DIR_ENV = "JAX_COMPILATION_CACHE_DIR"
# fixed, gitignored: the cache key includes the directory, so a path that
# moved between runs would never hit
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory:
    ``$JAX_COMPILATION_CACHE_DIR`` when set, else ``.jax_cache/`` at the
    checkout root. Entry points call this before their first compile, so a
    cold run of a large pattern set compiles each step once per machine."""
    import jax

    path = os.environ.get(CACHE_DIR_ENV) or DEFAULT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path
