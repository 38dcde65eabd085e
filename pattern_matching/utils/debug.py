"""Debug logging — the reference's DPRINTF family as a runtime subsystem.

The reference gates fprintf tracing behind ``-D_DEBUG`` at compile time
(``DPRINTF``/``DPRINTF2``, common.h:22-43). Here the switch is the
``TPM_DEBUG`` environment variable, read per call so tests and embedders
can toggle it without reimporting:

- ``TPM_DEBUG=1`` — framework events: engine/config choice, feeder file
  lifecycle, batch dispatch/decode summaries (the DPRINTF tier).
- ``TPM_DEBUG=2`` — adds device-side values via :func:`kernel_debug`
  (``jax.debug.print`` inside jitted code) and per-round detail (the
  DPRINTF2 tier). Device-side output is baked in at trace time: set the
  variable before the first scan of a shape (see kernel_debug docstring).

All output goes to stderr through the ``pattern_matching`` logger so
embedders can redirect it with standard ``logging`` configuration.
"""

from __future__ import annotations

import logging
import os
import sys

logger = logging.getLogger("pattern_matching")
_configured = False


def level() -> int:
    try:
        return int(os.environ.get("TPM_DEBUG", "0") or 0)
    except ValueError:
        return 0


def _ensure_handler() -> None:
    global _configured
    if _configured:
        return
    _configured = True
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("[tpm] %(message)s"))
        logger.addHandler(h)
    logger.setLevel(logging.DEBUG)


def dprint(lvl: int, msg: str, *args) -> None:
    """DPRINTF analogue: emit when TPM_DEBUG >= lvl."""
    if level() >= lvl:
        _ensure_handler()
        logger.debug(msg, *args)


def kernel_debug(fmt: str, *vals) -> None:
    """Device-side debug hook: prints traced values from inside jitted
    code when TPM_DEBUG >= 2 (compiles to a no-op otherwise — call
    sites pay nothing in production traces).

    CAVEAT: unlike :func:`dprint`, this gate is evaluated at TRACE time and
    baked into the compiled computation — jit caches mean toggling
    TPM_DEBUG after a shape has already traced has no effect on that shape
    (set the env var before the first scan to get device-side output)."""
    if level() >= 2:
        import jax

        jax.debug.print(fmt, *vals)
