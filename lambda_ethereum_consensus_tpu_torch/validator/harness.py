"""The duty-epoch walk: a :class:`.scheduler.DutyScheduler` operating N
keys walking mainnet-spec epoch-0 slots at the honest firing instants
(attest at 1/3 slot due by 2/3, aggregate at 2/3 due by the slot end),
deadline-judged by the scheduler's virtual-instant rule, its misses read
back from the telemetry registry.

The port's copy of the JAX package's ``validator/harness.py``, with the
``device`` the scheduler runs on (default: the card).

Only ``distinct_keys`` secret keys cycle across the registry: key
material does not change signing cost, while minting 10^4 distinct
pubkeys would dominate the setup.
"""

from __future__ import annotations

import time

from ..config import mainnet_spec, use_chain_spec
from ..crypto import bls
from ..telemetry import get_metrics
from ..tracing import SlotClock
from .scheduler import DutyScheduler

__all__ = ["walk_duty_epoch"]


def walk_duty_epoch(
    n_keys: int,
    n_slots: int,
    distinct_keys: int = 64,
    propose_at: int | None = None,
    device=None,
) -> dict:
    """Walk ``n_slots`` of epoch 0 with ``n_keys`` managed validators on
    a mainnet-spec genesis; returns production/miss/wall-time counts.
    ``propose_at`` additionally exercises the proposer path at that slot
    (devnet scale only — a 10^4-registry block assembly is the replay
    bench's territory).  The scheduler runs on ``device`` (default: the
    card)."""
    from ..state_transition.genesis import build_genesis_state

    sks = [(i + 1).to_bytes(32, "big") for i in range(distinct_keys)]
    pks = [bls.sk_to_pk(sk) for sk in sks]
    metrics = get_metrics()
    miss0 = metrics.get("duty_deadline_miss_total", type="attest")
    with use_chain_spec(mainnet_spec()) as spec:
        state = build_genesis_state(
            [pks[i % distinct_keys] for i in range(n_keys)], spec=spec
        )
        clock = SlotClock(0, int(spec.SECONDS_PER_SLOT), 3)
        sched = DutyScheduler(
            {i: sks[i % distinct_keys] for i in range(n_keys)},
            spec, clock=clock, device=device,
        )
        # the genesis block root as the chain computes it (state_root
        # filled) — so pooled votes survive the proposer path's full
        # in-block attestation validation
        head = state.latest_block_header.copy(
            state_root=state.hash_tree_root(spec)
        ).hash_tree_root(spec)
        attested = aggregated = 0
        proposed = False
        interval = spec.SECONDS_PER_SLOT / 3
        t0 = time.perf_counter()
        for slot in range(n_slots):
            # honest-validator firing instants: production must fit one
            # interval to make its broadcast boundary
            start = clock.slot_start(slot)
            attested += len(sched.produce_attestations(
                state, slot, head, now=start + interval
            ))
            aggregated += len(sched.produce_aggregates(
                state, slot, now=start + 2 * interval
            ))
        wall = time.perf_counter() - t0
        if propose_at is not None:
            produced = sched.produce_block(
                state, propose_at, now=clock.slot_start(propose_at)
            )
            proposed = produced is not None
    return {
        "keys": n_keys,
        "slots": n_slots,
        "attested": attested,
        "aggregated": aggregated,
        "proposed": proposed,
        "wall_s": wall,
        "deadline_misses": int(
            metrics.get("duty_deadline_miss_total", type="attest") - miss0
        ),
    }
