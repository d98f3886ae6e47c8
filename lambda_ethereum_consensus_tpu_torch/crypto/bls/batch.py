"""Batched signature verification (random linear combination), with
bisection blame.

The port's counterpart of the JAX package's ``crypto/bls/batch.py``.
``batch_verify`` checks N ``(pubkey, message, signature)`` triples with one
pairing-product equation instead of 2N pairings:

    prod_j e( sum_{i in group_j} r_i * pk_i , H(m_j) )
         * e( -g1, sum_i r_i * sig_i )  ==  1

with independent coefficients ``r_i`` of ``coeff_bits`` bits (default
:data:`COEFF_BITS`, 64, the JAX package's deployed ``BLS_RLC_BITS``), items
grouped by distinct message.

The route is decided by size alone, before anything launches (the JAX
package's ``BLS_DEVICE_CHAIN_MIN`` gate, here the module constant
:data:`DEVICE_CHAIN_MIN`).  A set of at least that many entries runs on
the device as one chained check (:func:`..ops.bls_batch.chain_verify`, whose
pairing tail has its own size route);
a smaller one runs on the host tail, :func:`_verify_points_host` (the native
C++ RLC check, else pure Python).  Either way the device is resolved first,
so ``device=None`` raises without a card at every size.  A failed range is
split in half, level by level; a level whose longest range reaches the
constant goes to the device together as one chained call, so ``b`` bad
items cost O(log N) device round trips.  The attestation drain and a block's
attestations check through an epoch committee cache instead
(``chain_verify_cached``: :func:`batch_verify_each_cached`,
:func:`verify_cached`); their callers pick that body, so those two are not
gated here.

The JAX package's containment re-verified on the host after a device fault;
here a device error raises.
"""

from __future__ import annotations

import os
import secrets
from typing import Sequence

from ...ops.rlc import COEFF_BITS
from ...ops.sha256 import resolve_device
from . import curve as C
from . import native
from .curve import DeserializationError
from .hash_to_curve import DST_POP, hash_to_g2
from .pairing import pairing_check

__all__ = [
    "COEFF_BITS",
    "DEVICE_CHAIN_MIN",
    "batch_verify",
    "batch_verify_each_cached",
    "batch_verify_each_points",
    "device_chain_threshold",
    "verify_cached",
    "verify_points",
]

# entry: (g1 affine point, message bytes, g2 affine point)
PointEntry = tuple

# entries from which a signature set's check runs on the device; below it
# the host tail answers.  The smallest set at which the card's chain, on
# its hybrid pairing tail, was at or below the native host tail on an H100
# (PERF.md, the median of six runs: 1.76 against 1.80 s at 16,384 entries,
# a near tie, 1.53 against 0.99 s at 8,192; two runs at 32,768: 1.99
# against 3.38 s).  The JAX package's
# BLS_DEVICE_CHAIN_MIN default, 128, was tuned to a TPU's dispatch cost.
DEVICE_CHAIN_MIN = 16384


def device_chain_threshold() -> int:
    """The set size from which :func:`verify_points` and each level of
    :func:`batch_verify_each_points` run on the device: the one place both
    read :data:`DEVICE_CHAIN_MIN`."""
    return DEVICE_CHAIN_MIN


def _message_point(message: bytes, dst: bytes, message_points: dict):
    h = message_points.get((message, dst))
    if h is None:
        h = message_points[(message, dst)] = hash_to_g2(message, dst)
    return h


def _pack_check(entry_list, dst, message_points, coeff_bits: int = COEFF_BITS):
    """``(pk, message, sig)`` entries -> a ``chain_verify`` check tuple,
    memoizing ``hash_to_g2`` through ``message_points``."""
    group_of: dict[bytes, int] = {}
    h_points: list = []
    gids = []
    packed = []
    for pk, message, sig in entry_list:
        g = group_of.get(message)
        if g is None:
            g = group_of[message] = len(h_points)
            h_points.append(_message_point(message, dst, message_points))
        gids.append(g)
        packed.append((pk, sig, secrets.randbits(coeff_bits) | 1))
    return (packed, h_points, gids)


def _bisect(n: int, dead, check_ranges) -> list[bool]:
    """Per-entry verdicts by level-synchronous bisection.  ``dead(i)``: entry
    ``i`` is invalid by definition (a range holding one fails without a
    check); ``check_ranges(ranges)`` verifies a whole level's live ranges in
    one call, one bool each."""
    flags = [False] * n
    pending = [list(range(n))] if n else []
    while pending:
        oks = {k: False for k, r in enumerate(pending) if any(dead(i) for i in r)}
        live = [(k, r) for k, r in enumerate(pending) if k not in oks]
        if live:
            for (k, _), ok in zip(live, check_ranges([r for _, r in live])):
                oks[k] = ok
        nxt: list[list[int]] = []
        for k, index_range in enumerate(pending):
            if oks[k]:
                for i in index_range:
                    flags[i] = True
            elif len(index_range) > 1:
                mid = len(index_range) // 2
                nxt.append(index_range[:mid])
                nxt.append(index_range[mid:])
        pending = nxt
    return flags


def _scale_entries(entries, coeffs, bits: int = COEFF_BITS, device=None):
    """``[(r_i * pk_i)], [(r_i * sig_i)]`` through the batched ladders on
    ``device`` (default: the card).  The JAX package's host tail scales
    through this above its own size gate (``BLS_DEVICE_MSM_MIN``); no entry
    point of the port calls it until that gate is ported."""
    from ...ops.bls_g1 import batch_g1_mul
    from ...ops.bls_g2 import batch_g2_mul

    pks = batch_g1_mul([pk for pk, _, _ in entries], coeffs, bits, device)
    sigs = batch_g2_mul([sig for _, _, sig in entries], coeffs, bits, device)
    return pks, sigs


def verify_points(
    entries: Sequence[PointEntry],
    dst: bytes = DST_POP,
    message_points: dict | None = None,
    device=None,
    coeff_bits: int = COEFF_BITS,
    host: bool = False,
) -> bool:
    """The RLC check over already-decompressed, subgroup-checked points:
    from :data:`DEVICE_CHAIN_MIN` entries up one chained check on ``device``
    (default: the card, resolved first at every size), below it the host
    tail :func:`_verify_points_host`; ``host=True`` asks for the host tail
    at any size.

    A ``None`` point is undecodable, so the batch is invalid.
    ``message_points`` memoizes ``hash_to_g2`` across calls.
    """
    if not entries:
        return True
    if any(pk is None or sig is None for pk, _, sig in entries):
        return False
    if message_points is None:
        message_points = {}
    if host:
        return _verify_points_host(entries, dst, message_points, coeff_bits)
    dev = resolve_device(device)
    if len(entries) < device_chain_threshold():
        return _verify_points_host(entries, dst, message_points, coeff_bits)
    from ...ops import bls_batch

    check = _pack_check(entries, dst, message_points, coeff_bits)
    return bls_batch.chain_verify([check], dev, coeff_bits)[0]


def _verify_points_host(
    entries: Sequence[PointEntry],
    dst: bytes,
    message_points: dict,
    coeff_bits: int = COEFF_BITS,
) -> bool:
    """The RLC check on the host: the whole check in C++ through the native
    library's ``rlc_verify`` (scalar products, group sums, lockstep Miller
    loops, one final exponentiation), unless :func:`.native.enabled` is off
    or ``BLS_NO_NATIVE_RLC`` is set; else in Python, per-entry scalar
    products, group sums and :func:`.pairing.pairing_check`."""
    no_rlc = os.environ.get("BLS_NO_NATIVE_RLC", "").strip().lower()
    if native.enabled() and no_rlc in ("", "0", "false", "no", "off"):
        packed, h_points, gids = _pack_check(entries, dst, message_points, coeff_bits)
        return native.rlc_verify(packed, h_points, gids, coeff_bits)
    coeffs = [secrets.randbits(coeff_bits) | 1 for _ in entries]
    scaled_pks = [C.g1.multiply_raw(pk, r) for (pk, _, _), r in zip(entries, coeffs)]
    scaled_sigs = [C.g2.multiply_raw(sig, r) for (_, _, sig), r in zip(entries, coeffs)]
    by_message: dict[bytes, C.AffinePoint] = {}
    sig_acc: C.AffinePoint = None
    for (_, message, _), scaled_pk, scaled_sig in zip(entries, scaled_pks, scaled_sigs):
        by_message[message] = C.g1.affine_add(by_message.get(message), scaled_pk)
        sig_acc = C.g2.affine_add(sig_acc, scaled_sig)
    pairs = [(pk_sum, _message_point(message, dst, message_points))
             for message, pk_sum in by_message.items()]
    pairs.append((C.g1.affine_neg(C.G1_GENERATOR), sig_acc))
    return pairing_check(pairs)


def batch_verify_each_points(
    entries: Sequence[PointEntry],
    dst: bytes = DST_POP,
    message_points: dict | None = None,
    device=None,
    coeff_bits: int = COEFF_BITS,
) -> list[bool]:
    """Per-entry validity of ``(pk, message, sig)`` point entries with
    bisection blame.  A level whose longest range reaches
    :data:`DEVICE_CHAIN_MIN` goes to ``device`` (default: the card, resolved
    first at every size) as one chained call; a smaller level checks each
    range on the host tail.  Ranges holding a ``None`` point fail without a
    check."""
    from ...ops import bls_batch

    dev = resolve_device(device)
    if message_points is None:
        message_points = {}

    def check_ranges(ranges):
        if max(map(len, ranges)) < device_chain_threshold():
            return [_verify_points_host([entries[i] for i in r], dst, message_points, coeff_bits)
                    for r in ranges]
        checks = [_pack_check([entries[i] for i in r], dst, message_points, coeff_bits)
                  for r in ranges]
        return bls_batch.chain_verify(checks, dev, coeff_bits)

    return _bisect(len(entries), lambda i: entries[i][0] is None or entries[i][2] is None,
                   check_ranges)


def _pack_cached(entries, index_range, dst: bytes, message_points: dict, coeff_bits: int):
    """One ``chain_verify_cached`` check over ``entries[index_range]``: each
    entry's committee id, missing members, signature and a fresh
    coefficient, grouped by distinct message."""
    group_of: dict[bytes, int] = {}
    h_points: list = []
    gids = []
    packed = []
    for i in index_range:
        comm_id, miss, message, sig = entries[i]
        g = group_of.get(message)
        if g is None:
            g = group_of[message] = len(h_points)
            h_points.append(_message_point(message, dst, message_points))
        gids.append(g)
        packed.append((comm_id, miss, sig, secrets.randbits(coeff_bits) | 1))
    return (packed, h_points, gids)


def verify_cached(
    cache,
    entries: Sequence[tuple],
    dst: bytes = DST_POP,
    message_points: dict | None = None,
    coeff_bits: int = COEFF_BITS,
) -> bool:
    """All-or-nothing check of :func:`batch_verify_each_cached`'s entries as
    ONE chained check over the committee cache, with no blame: a block's
    attestations have one verdict between them."""
    from ...ops import bls_batch

    if not entries:
        return True
    if any(entry[3] is None for entry in entries):
        return False
    check = _pack_cached(entries, range(len(entries)), dst,
                         {} if message_points is None else message_points, coeff_bits)
    return bls_batch.chain_verify_cached(cache, [check], coeff_bits)[0]


def batch_verify_each_cached(
    cache,
    entries: Sequence[tuple],
    dst: bytes = DST_POP,
    message_points: dict | None = None,
    coeff_bits: int = COEFF_BITS,
) -> list[bool]:
    """Per-entry validity over a :class:`..ops.bls_batch.DeviceCommitteeCache`.

    Entries are ``(comm_id, miss_members, message, sig_point)``; the
    aggregate pubkey is ``full_sum[comm_id] - sum(missing)`` on the device
    the cache lives on.  Callers guarantee miss lists within
    ``cache.mmax``, non-empty participation, and signatures decompressed and
    subgroup-checked (a ``None`` signature is undecodable, hence invalid).
    ``message_points`` memoizes ``hash_to_g2`` across calls.
    """
    from ...ops import bls_batch

    if message_points is None:
        message_points = {}

    def check_ranges(ranges):
        checks = [_pack_cached(entries, r, dst, message_points, coeff_bits) for r in ranges]
        return bls_batch.chain_verify_cached(cache, checks, coeff_bits)

    return _bisect(len(entries), lambda i: entries[i][3] is None, check_ranges)


def batch_verify(
    items: Sequence[tuple[bytes, bytes, bytes]],
    dst: bytes = DST_POP,
    device=None,
    coeff_bits: int = COEFF_BITS,
) -> bool:
    """All-or-nothing batch over ``(pubkey, message, signature)`` byte
    triples, verified as one check through :func:`verify_points` (routed by
    size; ``device`` defaults to the card)."""
    if not items:
        return True
    from .api import _pubkey_point

    try:
        entries = [
            (_pubkey_point(bytes(pk)), message, C.g2_from_bytes(sig))
            for pk, message, sig in items
        ]
    except DeserializationError:
        return False
    return verify_points(entries, dst, device=device, coeff_bits=coeff_bits)
