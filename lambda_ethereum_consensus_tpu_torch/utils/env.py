"""Environment-flag parsing: the port's copy of the JAX package's
``utils/env.env_flag``.  The port reads environment flags only for
operator switches that pick no path (``TELEMETRY_OFF``)."""

from __future__ import annotations

import os

__all__ = ["env_flag"]


def env_flag(name: str) -> bool:
    """One truthiness parse for every flag, so spellings like
    ``off``/``False`` never enable a switch by accident."""
    return os.environ.get(name, "").strip().lower() not in (
        "", "0", "false", "no", "off",
    )
