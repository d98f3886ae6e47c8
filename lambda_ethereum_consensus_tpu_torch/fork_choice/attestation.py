"""Epoch-scoped attestation verification context — the node path's bridge
from fork choice to the device committee cache.

The port's copy of the JAX package's ``fork_choice/attestation.py``.
Committee membership is fixed per epoch (the shuffling seed feeding
``get_beacon_committee``), so per target checkpoint we precompute

- the epoch's full committee table as ONE numpy matrix (one cached
  shuffling permutation, sliced — no per-committee Python walks),
- every committee's full pubkey sum on the device (``DeviceCommitteeCache``),
- the attester domain and per-validator effective balances,

and each drain then reduces every aggregate to ``(committee_id,
missing_member_indices)`` with numpy bit ops — the device computes
``full_sum - sum(missing)`` and runs the whole RLC chain without the
aggregate pubkey ever touching the host.

A context lives on one device (``device=None`` means the card, resolved
when the context is made, with the current card's index filled in so that
``"cuda"`` and ``"cuda:0"`` share one context): its committee cache is
built there, over the chain's shared registry planes on that device.
"""

from __future__ import annotations

import numpy as np

from ..config import ChainSpec, constants, get_chain_spec
from ..ops.bls_batch import _indexed_device
from ..ops.sha256 import resolve_device
from ..state_transition import accessors, misc
from ..state_transition.errors import SpecError
from ..state_transition.mutable import BeaconStateMut
from ..telemetry import get_metrics

__all__ = [
    "EpochAttestationContext",
    "get_attestation_context",
    "get_state_attestation_context",
    "registry_planes",
    "device_plane_store",
    "state_context_count",
]


# ---------------------------------------------------------- registry planes
#
# Packed (32, N) limb planes of every validator pubkey, keyed by the
# chain (genesis_validators_root) and grown incrementally: a validator's
# pubkey never changes once registered, so index i's planes are valid
# for every state of the chain with > i validators.
_REGISTRY_PLANES: dict[bytes, dict] = {}


def _registry_points(pubkeys: list[bytes]) -> tuple[list, np.ndarray]:
    """Decompress registry pubkeys: dedupe call-locally (each real index is
    decompressed exactly once because the planes cache grows
    monotonically), then one batch for the unique keys through
    :func:`..crypto.bls.curve.g1_from_bytes_batch` (the native library's
    thread pool, or point by point under ``BLS_DISABLE_NATIVE``).  Returns
    the unique points and each pubkey's index among them."""
    from ..crypto.bls.curve import g1_from_bytes_batch

    slot: dict[bytes, int] = {}
    index = np.fromiter((slot.setdefault(pk, len(slot)) for pk in pubkeys), np.int64,
                        len(pubkeys))
    points = g1_from_bytes_batch(list(slot))
    if any(pt is None or pt is False for pt in points):
        raise SpecError("registry pubkey is invalid or the identity")
    return points, index


def registry_planes(state, spec: ChainSpec | None = None):
    """``(rx, ry)`` numpy planes for ``state``'s full validator registry.

    Only indices beyond the cached count are decompressed and packed on
    a call (a validator's pubkey never changes once registered).
    """
    from ..ops.bls_batch import _g1_planes

    key = bytes(state.genesis_validators_root)
    entry = _REGISTRY_PLANES.get(key)
    n = len(state.validators)
    if entry is None:
        entry = _REGISTRY_PLANES[key] = {"count": 0, "rx": None, "ry": None}
    if entry["count"] < n:
        points, index = _registry_points(
            [bytes(state.validators[i].pubkey) for i in range(entry["count"], n)]
        )
        # pack each distinct key once, then gather its column per index
        ux, uy = _g1_planes(points)
        tx, ty = np.ascontiguousarray(ux[:, index]), np.ascontiguousarray(uy[:, index])
        if entry["rx"] is None:
            entry["rx"], entry["ry"] = tx, ty
        else:
            entry["rx"] = np.concatenate([entry["rx"], tx], axis=1)
            entry["ry"] = np.concatenate([entry["ry"], ty], axis=1)
        entry["count"] = n
    return entry["rx"][:, :n], entry["ry"][:, :n]


def device_plane_store(state, spec: ChainSpec | None = None, device=None):
    """The chain's shared registry-plane store on ``device`` (default: the
    card), grown to cover ``state``'s registry: every
    ``DeviceCommitteeCache`` the chain builds there references ONE device
    buffer, so device memory for registry data is O(registry), not
    O(live contexts x registry)."""
    from ..ops.bls_batch import get_plane_store

    dev = resolve_device(device)
    rx, ry = registry_planes(state, spec)
    store = get_plane_store(bytes(state.genesis_validators_root), dev)
    store.update(rx, ry)
    return store


class EpochAttestationContext:
    """Everything attestation verification needs about one target epoch,
    with its committee cache on ``device`` (default: the card)."""

    def __init__(self, target_state, epoch: int, spec: ChainSpec, device=None):
        self.spec = spec
        self.device = _indexed_device(device)
        self.epoch = int(epoch)
        self.state = target_state
        ws = BeaconStateMut(target_state)
        active = np.asarray(ws.active_indices(self.epoch), np.int64)
        # the ONE spec formula (accessors.get_committee_count_per_slot);
        # passing the mutable view keeps its active-set scan vectorized
        self.committees_per_slot = accessors.get_committee_count_per_slot(
            ws, self.epoch, spec
        )
        self.count = self.committees_per_slot * spec.SLOTS_PER_EPOCH
        self.start_slot = misc.compute_start_slot_at_epoch(self.epoch, spec)
        seed = accessors.get_seed(
            target_state, self.epoch, constants.DOMAIN_BEACON_ATTESTER, spec
        )
        perm = misc.compute_shuffled_indices(
            len(active), seed, spec.SHUFFLE_ROUND_COUNT
        )
        shuffled = active[perm]  # validator index per shuffled position
        total = len(active)
        bounds = np.array(
            [total * i // self.count for i in range(self.count + 1)], np.int64
        )
        self.lengths = (bounds[1:] - bounds[:-1]).astype(np.int64)
        kmax = int(self.lengths.max()) if self.count else 0
        self.kmax = kmax
        table = np.zeros((self.count, kmax), np.int32)
        for cid in range(self.count):
            table[cid, : self.lengths[cid]] = shuffled[bounds[cid] : bounds[cid + 1]]
        self.committees = table
        self.domain = accessors.get_domain(
            target_state, constants.DOMAIN_BEACON_ATTESTER, self.epoch, spec
        )
        self.eff_balance = ws.registry()["effective_balance"].astype(np.int64)
        self.n_validators = len(target_state.validators)
        self._device_cache = None
        self._signing_roots: dict = {}  # AttestationData root memo
        self.message_points: dict = {}  # hash_to_g2 memo shared across drains

    # -------------------------------------------------------------- lookups

    def committee_id(self, slot: int, index: int) -> int:
        """Flat committee id for (slot, committee_index); raises on bad
        coordinates (spec: index < committees_per_slot, slot in epoch)."""
        if not 0 <= index < self.committees_per_slot:
            raise SpecError(f"committee index {index} out of range")
        if misc.compute_epoch_at_slot(slot, self.spec) != self.epoch:
            raise SpecError("attestation slot not in target epoch")
        return (slot - self.start_slot) * self.committees_per_slot + int(index)

    def committee(self, cid: int) -> np.ndarray:
        return self.committees[cid, : self.lengths[cid]]

    def signing_root(self, data) -> bytes:
        key = (int(data.slot), int(data.index), bytes(data.beacon_block_root),
               int(data.source.epoch), bytes(data.source.root),
               bytes(data.target.root))
        root = self._signing_roots.get(key)
        if root is None:
            root = misc.compute_signing_root(data, self.domain)
            self._signing_roots[key] = root
        return root

    def participation(self, att) -> tuple[int, np.ndarray, np.ndarray]:
        """``(committee_id, attesting, missing)`` for one attestation,
        from numpy bit ops over the committee row.  Raises ``SpecError``
        on committee/bits mismatch (the structural check
        ``get_attesting_indices`` performs on the per-item path)."""
        cid = self.committee_id(int(att.data.slot), int(att.data.index))
        k = int(self.lengths[cid])
        bits = att.aggregation_bits
        if len(bits) != k:
            raise SpecError("aggregation bits do not match committee size")
        if hasattr(bits, "to_bytes"):  # ssz Bits value (the wire shape)
            mask = np.unpackbits(
                np.frombuffer(bits.to_bytes(), np.uint8), bitorder="little"
            )[:k].astype(bool)
        else:  # hand-built sequences in tests
            mask = np.asarray([bool(b) for b in bits])
        row = self.committees[cid, :k]
        return cid, row[mask], row[~mask]

    # --------------------------------------------------------------- device

    def device_cache(self):
        """Lazy epoch committee cache on the context's device (built once
        per context — i.e. once per (epoch, target) — and reused by every
        drain) over the chain's SHARED plane store there."""
        if self._device_cache is None:
            from ..ops.bls_batch import DeviceCommitteeCache

            store = device_plane_store(self.state, self.spec, self.device)
            self._device_cache = DeviceCommitteeCache(
                store,
                self.committees,
                lengths=self.lengths,
                chunk=min(256, max(1, self.count)),
            )
        return self._device_cache


# ------------------------------------------------------------ context cache

_STATE_CTX: dict = {}
_STATE_CTX_CAP = 7
_STORE_CTX_CAP = 8  # a node tracks current+previous epoch targets


def _evict_oldest_epoch(
    cache: dict, cap: int, epoch_of, keep=None, kind: str = "store"
) -> None:
    """Oldest-epoch LRU eviction down to ``cap`` entries.

    The victim is the entry with the SMALLEST epoch; recency (dict
    insertion order — getters refresh hits by re-inserting) breaks ties,
    so the hot current-epoch contexts survive an epoch boundary.

    ``keep`` exempts one key from the victim pick.  The replay getter
    passes its just-inserted key: a backfill segment older than every
    cached epoch would otherwise insert-and-self-evict on EVERY block.
    The gossip getter does NOT — there a stale-epoch straggler is the
    right victim.  Each eviction counts
    ``attestation_context_evictions_count{cache=kind}``: a hot-context
    victim means the cap is too small for the fork pattern on gossip.
    """
    while len(cache) > cap:
        victim = min(
            (item for item in enumerate(cache) if item[1] != keep),
            key=lambda item: (epoch_of(item[1]), item[0]),
        )[1]
        del cache[victim]
        get_metrics().inc("attestation_context_evictions_count", cache=kind)


def state_context_count() -> int:
    """Live state-keyed contexts (the node's per-tick cache-size gauge)."""
    return len(_STATE_CTX)


def get_state_attestation_context(
    state, epoch: int, spec: ChainSpec | None = None, device=None
) -> EpochAttestationContext:
    """Context for block-attestation verification inside the state
    transition (no fork-choice store involved), keyed by what actually
    determines the epoch's committees — chain + epoch + shuffling seed +
    registry length — and by ``device`` (default: the card).  Within an
    epoch the active set at that epoch is stable for a given length, so
    replaying a segment reuses one context per epoch."""
    spec = spec or get_chain_spec()
    dev = _indexed_device(device)
    seed = accessors.get_seed(
        state, int(epoch), constants.DOMAIN_BEACON_ATTESTER, spec
    )
    key = (
        bytes(state.genesis_validators_root),
        int(epoch),
        seed,
        len(state.validators),
        dev,
    )
    ctx = _STATE_CTX.pop(key, None)
    if ctx is not None:
        _STATE_CTX[key] = ctx  # refresh recency
        return ctx
    ctx = _STATE_CTX[key] = EpochAttestationContext(state, int(epoch), spec, dev)
    _evict_oldest_epoch(_STATE_CTX, _STATE_CTX_CAP, lambda k: k[1], keep=key, kind="state")
    return ctx


def get_attestation_context(
    store, target, target_state, spec: ChainSpec | None = None, device=None
) -> EpochAttestationContext:
    """Context for a target checkpoint on ``device`` (default: the card),
    cached on the store keyed ``(epoch, root, device)``.  Overflow evicts
    the oldest-epoch context (LRU within an epoch) instead of clearing, and
    finalization prunes the map alongside ``checkpoint_states``
    (:meth:`..store.Store.prune_checkpoint_caches`)."""
    spec = spec or get_chain_spec()
    dev = _indexed_device(device)
    key = (int(target.epoch), bytes(target.root), dev)
    caches = store.attestation_contexts
    ctx = caches.pop(key, None)
    if ctx is not None:
        caches[key] = ctx  # refresh recency
        return ctx
    ctx = caches[key] = EpochAttestationContext(
        target_state, int(target.epoch), spec, dev
    )
    _evict_oldest_epoch(caches, _STORE_CTX_CAP, lambda k: k[0])
    return ctx
