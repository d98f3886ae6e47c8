"""Batched BLS signing (G2): the mirror image of the verify plane.

The port's counterpart of the JAX package's ``ops/bls_sign.py``.  A
signature is ``sk * hash_to_G2(message)``, so signing N duty messages for an
operator's keys is the G2 double-and-add ladder the verify plane already
runs, with the scalar secret instead of random.  Two routes, both bit-exact
against the host ``api.sign`` oracle (affine coordinates are unique, so
equal group math means equal compressed bytes):

- **device** (:func:`_sign_points_device`): the G2 plane ladder
  (:mod:`.bls_g2`) on the card over the batch as it is, chunked past
  :data:`SIGN_CHUNK` signatures; affine on the host through the Fq2 norm
  trick.  Flushes of at least :data:`DUTY_SIGN_MIN` signatures take it.
  The chunks in flight count in :mod:`.profile`'s ``duty_sign_ladders``
  plane.
- **host** (:func:`_sign_points_host`, smaller flushes or ``host=True``):
  the native library's scalar multiplication per signature, or, with the
  native library off, shared-base fixed-window comb tables per distinct
  message point, so one table serves every signer of a committee's
  message.

Messages hash on the host, once per distinct message.  Every key and width
guard raises :class:`..crypto.bls.api.BlsError` before any device work.  The
JAX package's drop to the host route on a device fault is not carried over:
a device error raises.  Nor are its ``duty_sign`` shape buckets, which padded
each flush to a precompiled TPU program's size: the CUDA kernels take any
lane count.
"""

from __future__ import annotations

import threading
import time
from typing import Sequence

from ..crypto.bls import curve as C
from ..crypto.bls import native
from ..crypto.bls.api import BlsError
from ..crypto.bls.fields import R
from ..crypto.bls.hash_to_curve import DST_POP, hash_to_g2_many
from ..telemetry import inc, span
from .bls_g1 import SCALAR_BITS
from .bls_g2 import g2_affine, g2_ladder
from .profile import register_plane
from .sha256 import resolve_device

__all__ = [
    "DUTY_SIGN_MIN",
    "SIGN_CHUNK",
    "sign_batch",
    "warm_sign_programs",
]

#: The most signatures one ladder dispatch takes: a slot's duties for about
#: 32,768 validators.  Larger flushes run in chunks of this size, which
#: bounds device memory.
SIGN_CHUNK = 1024

#: The fewest signatures a flush sends to the card's ladder; smaller flushes
#: take the host route.  On an H100 (700 W) the ladder lost to the host
#: route at every flush size measured, 2,048 signatures included (medians
#: 5.49 against 3.29 s at 2,048, 3.17 against 1.81 s at 1,024): the ladder
#: costs the same for each chunk of SIGN_CHUNK signatures, the host route
#: the same for each signature, so the card loses at every size.  This is
#: one more than the largest flush the scheduler makes at 10^6 validators
#: (a slot's 31,250 attesters).
DUTY_SIGN_MIN = 31_251

# fixed-window width of the host comb, and the smallest group that builds a
# table (smaller groups run the plain multiply)
_COMB_W = 4
_COMB_MIN = 3


def _sk_scalar(secret_key: bytes) -> int:
    """The host oracle's key guard: 32 bytes, value in (0, R)."""
    if len(secret_key) != 32:
        raise BlsError("private key must be 32 bytes")
    sk = int.from_bytes(secret_key, "big")
    if sk == 0 or sk >= R:
        raise BlsError("private key out of range")
    return sk


# ------------------------------------------------------------ device plane

# Device bytes of the Jacobian planes (X, Y, Z as (32, 2, n) int32, the
# (n,) infinity flags) of the ladder chunks in flight, from the ladder's
# start to the end of their affine conversion: the sign path's share of the
# card's memory (it keeps nothing between flushes).
_LADDER_BYTES_PER_LANE = 3 * 32 * 2 * 4 + 1
_in_flight = [0]
_in_flight_lock = threading.Lock()
register_plane("duty_sign_ladders", lambda: _in_flight[0])


def _sign_points_device(
    points: list, scalars: list, nbits: int = SCALAR_BITS, device=None
) -> list:
    """``[k_i * Q_i]`` through the G2 plane ladder on ``device`` (default:
    the card); affine Fq2 pairs out."""
    dev = resolve_device(device)
    out: list = []
    for at in range(0, len(points), SIGN_CHUNK):
        chunk = points[at : at + SIGN_CHUNK]
        held = len(chunk) * _LADDER_BYTES_PER_LANE
        with _in_flight_lock:
            _in_flight[0] += held
        try:
            jac = g2_ladder(chunk, scalars[at : at + SIGN_CHUNK], nbits, dev)
            out.extend(g2_affine(jac))
        finally:
            with _in_flight_lock:
                _in_flight[0] -= held
    return out


# -------------------------------------------------------------- host comb


def _comb_tables(pt) -> list:
    """Fixed-base window tables ``T[i][d] = (d << (w*i)) * pt`` in Jacobian
    form, built once per distinct message point."""
    nwin = (SCALAR_BITS + _COMB_W - 1) // _COMB_W
    tables = []
    base = C.g2.to_jacobian(pt)
    for _ in range(nwin):
        row: list = [None] * (1 << _COMB_W)
        row[1] = base
        for d in range(2, 1 << _COMB_W):
            row[d] = C.g2.jac_add(row[d - 1], base)
        tables.append(row)
        for _ in range(_COMB_W):
            base = C.g2.jac_double(base)
    return tables


def _comb_mul(tables: list, k: int):
    acc = (C.g2.one, C.g2.one, C.g2.zero)
    i = 0
    while k:
        d = k & ((1 << _COMB_W) - 1)
        if d:
            acc = C.g2.jac_add(acc, tables[i][d])
        k >>= _COMB_W
        i += 1
    return C.g2.from_jacobian(acc)


def _sign_points_host(points: list, scalars: list) -> list:
    """The host route: ``multiply_raw`` per entry, which is the native
    library's scalar multiplication while :func:`.native.enabled`; with it
    off, entries grouped by base point and one comb table per group of at
    least ``_COMB_MIN`` (smaller groups run the plain multiply)."""
    by_pt: dict = {}
    for i, pt in enumerate(points):
        by_pt.setdefault(pt, []).append(i)
    out: list = [None] * len(points)
    comb = not native.enabled()
    for pt, members in by_pt.items():
        if comb and len(members) >= _COMB_MIN:
            tables = _comb_tables(pt)
            for i in members:
                out[i] = _comb_mul(tables, scalars[i])
        else:
            for i in members:
                out[i] = C.g2.multiply_raw(pt, scalars[i])
    return out


# ---------------------------------------------------------------- surface


def sign_batch(
    secret_keys: Sequence[bytes],
    messages: Sequence[bytes],
    dst: bytes = DST_POP,
    device=None,
    nbits: int = SCALAR_BITS,
    host: bool = False,
) -> list[bytes]:
    """Sign ``messages[i]`` with ``secret_keys[i]``: compressed 96-byte
    signatures, bit-exact with ``api.sign`` per item.

    ``device`` (default: the card) is resolved first at every size; a flush
    of at least :data:`DUTY_SIGN_MIN` signatures runs the ladder there, a
    smaller one the host route, and ``host=True`` the host route at any
    size.  Distinct messages hash once.  ``nbits`` narrows the ladder for
    reduced-width test scalars (every real key needs the full 256-bit
    default)."""
    if len(secret_keys) != len(messages):
        raise BlsError(f"{len(secret_keys)} keys for {len(messages)} messages")
    if not secret_keys:
        return []
    if nbits % 8:
        raise BlsError(f"ladder width must be a multiple of 8, got {nbits}")
    scalars = [_sk_scalar(sk) for sk in secret_keys]
    if any(k >> nbits for k in scalars):
        raise BlsError(f"secret scalar wider than the {nbits}-bit ladder")
    dev = None if host else resolve_device(device)
    on_card = dev is not None and len(scalars) >= DUTY_SIGN_MIN
    distinct: dict[bytes, int] = {}
    for msg in messages:
        distinct.setdefault(bytes(msg), len(distinct))
    hashed = hash_to_g2_many(list(distinct), dst)
    points = [hashed[distinct[bytes(msg)]] for msg in messages]
    with span("duty_sign"):
        if on_card:
            out = _sign_points_device(points, scalars, nbits, dev)
        else:
            out = _sign_points_host(points, scalars)
    inc("duty_signatures_total", len(out), path="device" if on_card else "host")
    return [C.g2_to_bytes(pt) for pt in out]


def warm_sign_programs(device=None) -> float:
    """One 8-bit, one-lane dispatch on ``device`` (default: the card), so
    that a slot's first duty flush finds the kernels built and loaded.
    Returns the seconds it took."""
    t0 = time.perf_counter()
    _sign_points_device([C.G2_GENERATOR], [1], 8, device)
    return time.perf_counter() - t0
