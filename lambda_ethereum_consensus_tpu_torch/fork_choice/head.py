"""LMD-GHOST head selection (ref: lib/.../fork_choice/helpers.ex:53-193).

The port's copy of the JAX package's ``fork_choice/head.py``: only the cold
walk is timed (``fork_choice_head_recompute``) and audited (the store's
forensics plane, when one is attached); a memo hit stays O(1) with no
instrumentation.

``get_weight`` in the reference is an O(validators) Elixir scan per tree node
(helpers.ex:75-90).  Here one batched pass groups the latest messages by vote
root (numpy), resolves each *unique* vote root's ancestor once, and reduces
effective balances per subtree — O(unique_roots x depth + n) per head call
instead of O(children x n) per tree level.
"""

from __future__ import annotations

from ..config import ChainSpec, constants, get_chain_spec
from ..state_transition import accessors, misc
from ..telemetry import span
from .store import Store, checkpoint_key


def _justified_state(store: Store):
    return store.checkpoint_states[checkpoint_key(store.justified_checkpoint)]


def _vote_weights_by_root(store: Store, spec: ChainSpec) -> dict[bytes, int]:
    """Total effective balance voting for each distinct head root."""
    state = _justified_state(store)
    current_epoch = accessors.get_current_epoch(state, spec)
    validators = state.validators
    weights: dict[bytes, int] = {}
    for i, msg in store.latest_messages.items():
        if i in store.equivocating_indices:
            continue
        v = validators[i]
        if v.slashed or not (v.activation_epoch <= current_epoch < v.exit_epoch):
            continue
        if msg.root not in store.blocks:
            continue
        weights[msg.root] = weights.get(msg.root, 0) + int(v.effective_balance)
    return weights


def get_proposer_score(store: Store, spec: ChainSpec | None = None) -> int:
    spec = spec or get_chain_spec()
    state = _justified_state(store)
    committee_weight = (
        accessors.get_total_active_balance(state, spec) // spec.SLOTS_PER_EPOCH
    )
    return committee_weight * spec.PROPOSER_SCORE_BOOST // 100


def _subtree_weight(
    store: Store, root: bytes, vote_weights: dict[bytes, int], spec: ChainSpec
) -> int:
    block_slot = store.blocks[root].slot
    attestation_score = 0
    for vote_root, weight in vote_weights.items():
        if store.get_ancestor(vote_root, block_slot) == root:
            attestation_score += weight
    if store.proposer_boost_root == b"\x00" * 32:
        return attestation_score
    proposer_score = 0
    if store.get_ancestor(store.proposer_boost_root, block_slot) == root:
        proposer_score = get_proposer_score(store, spec)
    return attestation_score + proposer_score


def get_weight(store: Store, root: bytes, spec: ChainSpec | None = None) -> int:
    """Attestation + proposer-boost weight of the subtree rooted at ``root``
    (ref: helpers.ex:75-106)."""
    spec = spec or get_chain_spec()
    return _subtree_weight(store, root, _vote_weights_by_root(store, spec), spec)


# ------------------------------------------------------- viable block tree

def get_voting_source(store: Store, block_root: bytes, spec: ChainSpec):
    """The justified checkpoint a vote for ``block_root`` would use."""
    block = store.blocks[block_root]
    current_epoch = misc.compute_epoch_at_slot(store.current_slot(spec), spec)
    block_epoch = misc.compute_epoch_at_slot(block.slot, spec)
    if current_epoch > block_epoch:
        return store.unrealized_justifications[block_root]
    return store.block_states[block_root].current_justified_checkpoint


def filter_block_tree(
    store: Store, block_root: bytes, blocks: dict, spec: ChainSpec
) -> bool:
    """Keep only branches whose leaves carry viable justification/finalization
    (ref: helpers.ex:110-177)."""
    children = [
        root
        for root in store.children.get(block_root, [])
        if root in store.blocks
    ]
    if children:
        keep = [filter_block_tree(store, child, blocks, spec) for child in children]
        if any(keep):
            blocks[block_root] = store.blocks[block_root]
            return True
        return False

    current_epoch = misc.compute_epoch_at_slot(store.current_slot(spec), spec)
    voting_source = get_voting_source(store, block_root, spec)
    correct_justified = (
        store.justified_checkpoint.epoch == constants.GENESIS_EPOCH
        or voting_source.epoch == store.justified_checkpoint.epoch
        or voting_source.epoch + 2 >= current_epoch
    )
    finalized_checkpoint_block = store.get_checkpoint_block(
        block_root, store.finalized_checkpoint.epoch, spec
    )
    correct_finalized = (
        store.finalized_checkpoint.epoch == constants.GENESIS_EPOCH
        or bytes(store.finalized_checkpoint.root) == finalized_checkpoint_block
    )
    if correct_justified and correct_finalized:
        blocks[block_root] = store.blocks[block_root]
        return True
    return False


def get_filtered_block_tree(store: Store, spec: ChainSpec) -> dict:
    base = bytes(store.justified_checkpoint.root)
    blocks: dict = {}
    filter_block_tree(store, base, blocks, spec)
    return blocks


def get_head(store: Store, spec: ChainSpec | None = None) -> bytes:
    """Greedy heaviest-observed-subtree walk from the justified root
    (ref: helpers.ex:53-73).

    Memoized on (store.mutations, current slot): repeated reads between
    store mutations — per-request API head resolution, per-tick telemetry
    — are O(1) instead of a full vote scan.  The slot is part of the key
    because viability filtering depends on the clock.
    """
    spec = spec or get_chain_spec()
    # belt and braces: the sizes catch direct-mutation callers that grow
    # blocks/votes/equivocations without going through bump() (vote MOVES
    # at constant count still require bump(), which every handler does)
    memo_key = _memo_key(store, spec)
    if store.head_memo is not None and store.head_memo[0] == memo_key:
        return store.head_memo[1]
    # the forensics audit hook rides ONLY the cold walk: memo hits stay
    # O(1) with zero instrumentation cost, and the scored lists
    # below are the same _subtree_weight calls max() would have made
    forensics = getattr(store, "forensics", None)
    if forensics is not None and not forensics.enabled:
        forensics = None
    branch_points: list | None = [] if forensics is not None else None
    # only the cold walk is spanned: a memo hit must stay O(1) with zero
    # instrumentation cost (it runs per API request and per tick)
    with span("fork_choice_head_recompute"):
        blocks = get_filtered_block_tree(store, spec)
        head = bytes(store.justified_checkpoint.root)
        # one vote scan per head call; the walk reuses it at every level
        vote_weights = _vote_weights_by_root(store, spec)
        boost = bytes(store.proposer_boost_root)
        while True:
            children = [
                root for root in store.children.get(head, []) if root in blocks
            ]
            if not children:
                store.head_memo = (memo_key, head)
                if branch_points is not None:
                    forensics.note_head_audit(
                        slot=store.current_slot(spec),
                        head=head,
                        branch_points=branch_points,
                        # filter verdicts: stored blocks the viability
                        # filter rejected from the walked tree (capped)
                        filtered_out=[
                            r for r in store.blocks if r not in blocks
                        ][:16],
                    )
                return head
            # weight-descending, root as tiebreak (spec: lexicographic max)
            scored = [
                (_subtree_weight(store, r, vote_weights, spec), r)
                for r in children
            ]
            if branch_points is not None and len(scored) > 1:
                branch_points.append({
                    "parent": "0x" + head.hex(),
                    "candidates": [
                        {
                            "root": "0x" + r.hex(),
                            "weight": int(w),
                            "boost": (
                                get_proposer_score(store, spec)
                                if boost != b"\x00" * 32
                                and store.get_ancestor(
                                    boost, store.blocks[r].slot
                                ) == r
                                else 0
                            ),
                        }
                        for w, r in sorted(scored, reverse=True)
                    ],
                })
            head = max(scored)[1]


def _memo_key(store: Store, spec: ChainSpec) -> tuple:
    return (
        store.mutations,
        store.current_slot(spec),
        len(store.blocks),
        len(store.latest_messages),
        len(store.equivocating_indices),
    )


def head_candidates(store: Store, spec: ChainSpec | None = None) -> dict:
    """Cheap head snapshot off the existing ``(mutations, slot)`` memo.
    NEVER forces an
    uncached full recompute: a stale memo is reported as ``fresh:
    false`` with the last memoized head, and the candidate detail comes
    from the forensics plane's last cold-walk audit (None until the
    first recompute lands)."""
    spec = spec or get_chain_spec()
    memo = store.head_memo
    fresh = memo is not None and memo[0] == _memo_key(store, spec)
    forensics = getattr(store, "forensics", None)
    return {
        "head": "0x" + memo[1].hex() if memo is not None else None,
        "fresh": bool(fresh),
        "mutations": int(store.mutations),
        "slot": int(store.current_slot(spec)),
        "last_audit": (
            forensics.last_audit() if forensics is not None else None
        ),
    }
