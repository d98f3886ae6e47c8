"""Attestation drain: per-entry verdicts over epoch-cached committee
aggregates, with bisection blame.

The port's counterpart of the JAX package's
``crypto/bls/batch.batch_verify_each_cached``.  Each check is one random
linear combination (RLC) over a range of entries, grouped by message:

    prod_j e( sum_{i in group_j} r_i * pk_i , H(m_j) )
         * e( -g1, sum_i r_i * sig_i )  ==  1

with independent coefficients ``r_i`` of ``coeff_bits`` bits (default 64,
the JAX package's deployed ``BLS_RLC_BITS``), verified whole on the device
(:func:`..ops.bls_batch.chain_verify_cached`).  A failed range is split in
half, level by level: every range of one bisection level goes to the device
together as one chained call.  There is no host fallback: the device the
cache lives on runs every check.
"""

from __future__ import annotations

import secrets
from typing import Sequence

from ...ops.bls_batch import COEFF_BITS
from .hash_to_curve import DST_POP, hash_to_g2

__all__ = ["batch_verify_each_cached"]


def batch_verify_each_cached(
    cache,
    entries: Sequence[tuple],
    dst: bytes = DST_POP,
    message_points: dict | None = None,
    coeff_bits: int = COEFF_BITS,
) -> list[bool]:
    """Per-entry validity over a :class:`..ops.bls_batch.DeviceCommitteeCache`.

    Entries are ``(comm_id, miss_members, message, sig_point)``; the
    aggregate pubkey is ``full_sum[comm_id] - sum(missing)`` on the device.
    Callers guarantee miss lists within ``cache.mmax``, non-empty
    participation, and signatures decompressed and subgroup-checked (a
    ``None`` signature is undecodable, hence invalid).  ``message_points``
    memoizes ``hash_to_g2`` across calls.
    """
    from ...ops.bls_batch import chain_verify_cached

    flags = [False] * len(entries)
    if message_points is None:
        message_points = {}

    def pack(index_range):
        group_of: dict[bytes, int] = {}
        h_points: list = []
        gids = []
        packed = []
        for i in index_range:
            comm_id, miss, message, sig = entries[i]
            g = group_of.get(message)
            if g is None:
                g = group_of[message] = len(h_points)
                h = message_points.get((message, dst))
                if h is None:
                    h = message_points[(message, dst)] = hash_to_g2(message, dst)
                h_points.append(h)
            gids.append(g)
            packed.append((comm_id, miss, sig, secrets.randbits(coeff_bits) | 1))
        return (packed, h_points, gids)

    pending = [list(range(len(entries)))] if len(entries) else []
    while pending:
        # ranges with an undecodable signature are invalid by definition
        dead_ranges = {
            k for k, r in enumerate(pending) if any(entries[i][3] is None for i in r)
        }
        live = [(k, r) for k, r in enumerate(pending) if k not in dead_ranges]
        oks = {k: False for k in dead_ranges}
        if live:
            verdicts = chain_verify_cached(cache, [pack(r) for _, r in live], coeff_bits)
            for (k, _), ok in zip(live, verdicts):
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
