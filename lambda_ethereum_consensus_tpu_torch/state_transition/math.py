"""Spec integer math helpers (ref: lib/.../state_transition/math.ex:10-18)."""

from __future__ import annotations

import math

UINT64_MAX = 2**64 - 1


def integer_squareroot(n: int) -> int:
    """Largest x with x*x <= n."""
    if n < 0:
        raise ValueError("negative input")
    return math.isqrt(n)


def saturating_sub(a: int, b: int) -> int:
    return a - b if a > b else 0
