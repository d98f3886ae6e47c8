"""Binary-Merkle multiproofs over the BeaconState, planned from the
incremental root engine's retained levels.

The SSZ tree of a BeaconState is addressed by **generalized indices**:
the root is 1, node ``g``'s children are ``2g``/``2g+1``.  A field at
schema position ``i`` sits at ``2^T + i`` (``T`` = container depth); a
List field's payload subtree hangs under ``2 * g_field`` with its length
mixed in at ``2 * g_field + 1``; chunk ``j`` of the payload sits at
``(2 * g_field) * 2^L + j`` (``L`` = the limit's subtree depth — 38 for
the 2^40-element registry lists).

A **multiproof** for a set of leaf gindices carries the leaf chunks plus
the minimal helper set: every sibling of a path node that is not itself
on a path (shared siblings are eliminated by construction — the helper
set is computed over the UNION of paths).  Helpers are ordered by
descending gindex (the canonical order both sides derive independently),
leaves by ascending gindex, so the sibling list is positional: a
truncated or padded proof fails the count check before any hashing.

Proof generation never rebuilds the tree: ``IncrementalStateRoot``
already retains every populated-subtree level per big field (that is how
it rehashes only dirty paths), so an arbitrary interior node is one
array row — or a ``ZERO_HASHES`` entry / spine hash for the unpopulated
region between the live elements and the 2^40 limit.

Verification is planned once per leaf-gindex set (:func:`plan_rounds`):
slots for leaves/helpers/internal nodes plus per-depth rounds of
``(left, right, out)`` hash triples.  The same plan drives both the
pure-host oracle (:func:`verify_host`, hashlib) and the batched device
plane (:mod:`.verify`), which is what makes the two bit-exact by
construction.

The port's copy of the JAX package's ``witness/multiproof.py``: numpy and
hashlib only, over the port's containers and engine.  A proof's
``encode()`` bytes are the same in both packages.  One change: the plan
cache is guarded by a lock, since verify requests plan on worker threads
(an unguarded hit can race another thread's eviction).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from ..config import get_chain_spec
from ..ssz.core import ByteVector, List as SszList, Uint, _resolve, _typ
from ..ssz.hash import ZERO_HASHES
from ..ssz.incremental import IncrementalStateRoot
from ..types.beacon import BeaconState

__all__ = [
    "MAX_PROOF_DEPTH",
    "MAX_PROOF_INDICES",
    "FieldMeta",
    "ProofPlan",
    "WitnessError",
    "WitnessPlanner",
    "WitnessProof",
    "helper_gindices",
    "plan_for",
    "plan_rounds",
    "verify_host",
    "witness_fields",
]

#: Hard bound on proof-tree depth (SSZ MAX_MERKLE_DEPTH): a gindex past
#: this is malformed, whatever else the proof claims.
MAX_PROOF_DEPTH = 64
#: Per-proof cap on requested indices — bounds planner work per request.
MAX_PROOF_INDICES = 1024
#: Engine cutoff: fields below this element limit use the "small"
#: (uncached) strategy in ssz/incremental.py, so no levels are retained
#: to serve proofs from (mirrors _classify's n_max < 4096 branch).
_MIN_WITNESS_LIMIT = 4096


def _sha(pair: bytes) -> bytes:
    return hashlib.sha256(pair).digest()


class WitnessError(ValueError):
    """Malformed witness request or proof (shape-level rejection)."""


# ------------------------------------------------------------ field layout


@dataclass(frozen=True)
class FieldMeta:
    """Witness-addressable field: a big List in the BeaconState schema."""

    name: str
    index: int  # schema position == top-level leaf index == wire code
    elem_bytes: int | None  # packed uint size; None = one leaf per element
    limit: int  # element limit (spec-resolved)
    limit_chunks: int
    depth: int  # payload subtree depth L

    @property
    def per_chunk(self) -> int:
        return 1 if self.elem_bytes is None else 32 // self.elem_bytes


_FIELDS_CACHE: dict[tuple[type, str], dict[str, FieldMeta]] = {}


def witness_fields(cls: type = BeaconState, spec=None) -> dict[str, FieldMeta]:
    """The witness-addressable fields of ``cls``: List fields big enough
    for the incremental engine to cache (balances, validators,
    inactivity scores, both participation columns, historical roots)."""
    spec = spec or get_chain_spec()
    key = (cls, spec.name)
    cached = _FIELDS_CACHE.get(key)
    if cached is not None:
        return cached
    out: dict[str, FieldMeta] = {}
    for i, (fname, ftype) in enumerate(cls.__ssz_schema__.items()):
        t = _typ(ftype)
        if not isinstance(t, SszList):
            continue
        limit = _resolve(t.limit, spec)
        if limit < _MIN_WITNESS_LIMIT:
            continue
        elem = _typ(t.elem)
        if isinstance(elem, Uint) and elem.size in (1, 2, 4, 8):
            elem_bytes = elem.size
            limit_chunks = (limit * elem.size + 31) // 32
        elif getattr(elem, "cls", None) is not None or isinstance(elem, ByteVector):
            elem_bytes = None
            limit_chunks = limit
        else:
            continue
        out[fname] = FieldMeta(
            name=fname,
            index=i,
            elem_bytes=elem_bytes,
            limit=limit,
            limit_chunks=limit_chunks,
            depth=max(limit_chunks - 1, 0).bit_length(),
        )
    _FIELDS_CACHE[key] = out
    return out


def _top_depth(cls: type) -> int:
    return max(len(cls.__ssz_schema__) - 1, 0).bit_length()


def leaf_gindex(meta: FieldMeta, chunk_index: int, top_depth: int) -> int:
    """Generalized index of payload chunk ``chunk_index`` of ``meta``."""
    g_field = (1 << top_depth) + meta.index
    return ((2 * g_field) << meta.depth) + chunk_index


# -------------------------------------------------------- helper selection


def helper_gindices(leaves) -> list[int]:
    """Canonical helper set for a leaf-gindex set: siblings of path nodes
    not themselves on any path, in DESCENDING gindex order.  Shared
    siblings collapse because the path set is the union over all leaves.
    Raises :class:`WitnessError` on an empty set or when one leaf is an
    ancestor of another (it would be simultaneously input and output)."""
    leaf_set = {int(g) for g in leaves}
    if not leaf_set:
        raise WitnessError("empty index set")
    path: set[int] = set()
    for g in leaf_set:
        if g < 2:
            raise WitnessError(f"gindex {g} cannot be a proof leaf")
        if g.bit_length() - 1 > MAX_PROOF_DEPTH:
            raise WitnessError(f"gindex {g} beyond max depth {MAX_PROOF_DEPTH}")
        node = g
        while node > 1:
            path.add(node)
            node >>= 1
    for g in leaf_set:
        if (2 * g) in path or (2 * g + 1) in path:
            raise WitnessError(f"leaf gindex {g} is an ancestor of another leaf")
    return sorted((g ^ 1 for g in path if (g ^ 1) not in path), reverse=True)


# ------------------------------------------------------------- proof value


@dataclass(frozen=True)
class WitnessProof:
    """One multiproof: leaf chunks + canonical sibling set under a root.

    ``indices`` records the REQUESTED (field, element index) pairs —
    element granularity; the proven unit is the 32-byte chunk (4 packed
    balances, or one validator's hash_tree_root).  ``leaves`` are
    ``(gindex, chunk)`` ascending; ``siblings`` follow the canonical
    descending-gindex helper order derived from the leaf set."""

    state_root: bytes
    indices: tuple  # ((field_name, element_index), ...)
    leaves: tuple  # ((gindex, bytes32), ...) ascending gindex
    siblings: tuple  # (bytes32, ...) descending helper gindex

    # ----------------------------------------------------------- encodings

    def to_json(self) -> dict:
        return {
            "state_root": "0x" + self.state_root.hex(),
            "indices": [[f, str(i)] for f, i in self.indices],
            "leaves": [[str(g), "0x" + c.hex()] for g, c in self.leaves],
            "siblings": ["0x" + s.hex() for s in self.siblings],
        }

    @classmethod
    def from_json(cls, obj) -> "WitnessProof":
        try:
            root = _hex32(obj["state_root"])
            indices = tuple(
                (str(f), int(i)) for f, i in obj.get("indices", [])
            )
            leaves = tuple(
                (int(g), _hex32(c)) for g, c in obj["leaves"]
            )
            siblings = tuple(_hex32(s) for s in obj["siblings"])
        except (KeyError, TypeError, ValueError) as e:
            raise WitnessError(f"malformed witness proof JSON: {e}") from None
        _check_counts(indices, leaves, siblings)
        return cls(root, indices, leaves, siblings)

    def encode(self) -> bytes:
        """Compact SSZ-style binary encoding (little-endian counts +
        fixed-width records); :meth:`decode` round-trips exactly."""
        fields = witness_fields()
        out = bytearray(self.state_root)
        out += len(self.indices).to_bytes(4, "little")
        for fname, idx in self.indices:
            meta = fields.get(fname)
            if meta is None:
                raise WitnessError(f"field {fname!r} is not witness-enabled")
            out += meta.index.to_bytes(4, "little")
            out += int(idx).to_bytes(8, "little")
        out += len(self.leaves).to_bytes(4, "little")
        for g, chunk in self.leaves:
            out += int(g).to_bytes(8, "little")
            out += chunk
        out += len(self.siblings).to_bytes(4, "little")
        for s in self.siblings:
            out += s
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "WitnessProof":
        data = bytes(data)
        by_code = {m.index: m.name for m in witness_fields().values()}
        pos = 0

        def take(n: int) -> bytes:
            nonlocal pos
            if pos + n > len(data):
                raise WitnessError("truncated witness proof encoding")
            blob = data[pos : pos + n]
            pos += n
            return blob

        def count() -> int:
            c = int.from_bytes(take(4), "little")
            if c > max(MAX_PROOF_INDICES, MAX_PROOF_INDICES * MAX_PROOF_DEPTH):
                raise WitnessError(f"implausible count {c} in proof encoding")
            return c

        root = take(32)
        indices = []
        for _ in range(count()):
            code = int.from_bytes(take(4), "little")
            idx = int.from_bytes(take(8), "little")
            fname = by_code.get(code)
            if fname is None:
                raise WitnessError(f"unknown witness field code {code}")
            indices.append((fname, idx))
        leaves = []
        for _ in range(count()):
            g = int.from_bytes(take(8), "little")
            leaves.append((g, take(32)))
        siblings = [take(32) for _ in range(count())]
        if pos != len(data):
            raise WitnessError(f"{len(data) - pos} trailing bytes in proof encoding")
        proof = cls(root, tuple(indices), tuple(leaves), tuple(siblings))
        _check_counts(proof.indices, proof.leaves, proof.siblings)
        return proof


def _hex32(s) -> bytes:
    if not isinstance(s, str):
        raise WitnessError(f"expected hex string, got {type(s).__name__}")
    raw = bytes.fromhex(s[2:] if s.startswith("0x") else s)
    if len(raw) != 32:
        raise WitnessError(f"expected 32 bytes, got {len(raw)}")
    return raw


def _check_counts(indices, leaves, siblings) -> None:
    if len(indices) > MAX_PROOF_INDICES or len(leaves) > MAX_PROOF_INDICES:
        raise WitnessError("proof exceeds the per-request index cap")
    if len(siblings) > MAX_PROOF_INDICES * MAX_PROOF_DEPTH:
        raise WitnessError("implausible sibling count")
    for _g, chunk in leaves:
        if len(chunk) != 32:
            raise WitnessError("leaf chunk is not 32 bytes")
    for s in siblings:
        if len(s) != 32:
            raise WitnessError("sibling is not 32 bytes")


# ---------------------------------------------------------------- planning


@dataclass(frozen=True)
class ProofPlan:
    """Deterministic verification schedule for one leaf-gindex set.

    Slot 0 is the per-proof scratch slot (padding ops in the batched
    plane dump there); leaves occupy slots 1..k ascending, helpers the
    next ``helper_count`` slots in canonical (descending-gindex) order,
    internal nodes after.  ``rounds`` is a tuple of rounds, each a tuple
    of ``(left_slot, right_slot, out_slot)`` hash triples; rounds only
    depend on earlier rounds' outputs, so all ops inside one round are
    data-parallel."""

    leaf_gindices: tuple
    helper_count: int
    n_slots: int
    rounds: tuple
    root_slot: int

    @property
    def max_round_ops(self) -> int:
        return max((len(r) for r in self.rounds), default=0)


_PLAN_CACHE: OrderedDict[tuple, ProofPlan] = OrderedDict()
_PLAN_CACHE_MAX = 256
# verify_batch runs on API worker threads: a hit's move_to_end must not
# race another thread's eviction of the same key
_PLAN_LOCK = threading.Lock()


def plan_rounds(leaf_gindices) -> ProofPlan:
    """Build (or fetch) the verification plan for a leaf-gindex set.
    Raises :class:`WitnessError` on malformed sets: empty, duplicated
    gindex, non-ascending order, ancestor conflicts, over-deep."""
    leaf_tuple = tuple(int(g) for g in leaf_gindices)
    with _PLAN_LOCK:
        cached = _PLAN_CACHE.get(leaf_tuple)
        if cached is not None:
            _PLAN_CACHE.move_to_end(leaf_tuple)
            return cached
    if not leaf_tuple:
        raise WitnessError("empty index set")
    if len(leaf_tuple) > MAX_PROOF_INDICES:
        raise WitnessError("proof exceeds the per-request index cap")
    if len(set(leaf_tuple)) != len(leaf_tuple):
        raise WitnessError("duplicated gindex in leaf set")
    if list(leaf_tuple) != sorted(leaf_tuple):
        raise WitnessError("leaf gindices must be in ascending canonical order")
    helpers = helper_gindices(leaf_tuple)

    slot: dict[int, int] = {}
    next_slot = 1  # slot 0 = scratch
    for g in leaf_tuple:
        slot[g] = next_slot
        next_slot += 1
    for g in helpers:
        slot[g] = next_slot
        next_slot += 1

    known = set(slot)
    rounds: list[tuple] = []
    max_depth = max(g.bit_length() - 1 for g in known)
    for depth in range(max_depth, 0, -1):
        ops = []
        for g in sorted(
            x for x in known if x.bit_length() - 1 == depth and not (x & 1)
        ):
            sib = g | 1
            if sib not in known:
                continue
            parent = g >> 1
            slot[parent] = next_slot
            next_slot += 1
            ops.append((slot[g], slot[sib], slot[parent]))
            known.add(parent)
        if ops:
            rounds.append(tuple(ops))
    if 1 not in slot:
        raise WitnessError("proof does not bind the root")
    plan = ProofPlan(
        leaf_gindices=leaf_tuple,
        helper_count=len(helpers),
        n_slots=next_slot,
        rounds=tuple(rounds),
        root_slot=slot[1],
    )
    with _PLAN_LOCK:
        _PLAN_CACHE[leaf_tuple] = plan
        while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
            _PLAN_CACHE.popitem(last=False)
    return plan


def plan_for(proof: WitnessProof) -> ProofPlan:
    """Plan for one proof + the positional shape checks that make the
    sibling list consumable: canonical leaf order and exact helper
    count (truncated/padded proofs fail here, before any hashing)."""
    plan = plan_rounds([g for g, _ in proof.leaves])
    if len(proof.siblings) != plan.helper_count:
        raise WitnessError(
            f"sibling count {len(proof.siblings)} != required "
            f"{plan.helper_count} for this leaf set"
        )
    return plan


def verify_host(proof: WitnessProof, expected_root: bytes) -> bool:
    """The pure-host oracle: execute the plan with hashlib and compare
    against ``expected_root``.  Malformed shapes reject (False), exactly
    as the batched device plane rejects them."""
    try:
        plan = plan_for(proof)
    except WitnessError:
        return False
    nodes: list[bytes | None] = [b"\x00" * 32] * plan.n_slots
    for i, (_g, chunk) in enumerate(proof.leaves):
        nodes[1 + i] = bytes(chunk)
    base = 1 + len(proof.leaves)
    for i, s in enumerate(proof.siblings):
        nodes[base + i] = bytes(s)
    for ops in plan.rounds:
        for left, right, out in ops:
            nodes[out] = _sha(nodes[left] + nodes[right])
    return nodes[plan.root_slot] == bytes(expected_root)


# ---------------------------------------------------------------- planner


def _subtree_node(levels, height: int, row: int) -> bytes:
    """Value of the node at ``height`` (0 = chunk level) and ``row`` of a
    populated subtree stored as retained levels, zero-extended beyond
    both the populated rows and the retained top (the spine up to the
    type's limit depth)."""
    if height > MAX_PROOF_DEPTH:
        raise WitnessError(f"node height {height} beyond max depth")
    if levels is None or levels[0].shape[0] == 0:
        return ZERO_HASHES[height]
    if height < len(levels):
        lvl = levels[height]
        if row < lvl.shape[0]:
            return lvl[row].tobytes()
        return ZERO_HASHES[height]
    if row > 0:
        return ZERO_HASHES[height]
    node = levels[-1][0].tobytes()
    for d in range(len(levels) - 1, height):
        node = _sha(node + ZERO_HASHES[d])
    return node


class WitnessPlanner:
    """Multiproof generation over one state lineage.

    Owns (or is handed) an :class:`IncrementalStateRoot`; the first
    ``prove`` against a state pays one engine root build, every later
    proof for the same state object reads retained levels only — zero
    hashing beyond the helper-spine extensions.  One planner tracks ONE
    state lineage, like the engine it wraps."""

    def __init__(self, cls: type = BeaconState, engine=None, backend=None):
        self.cls = cls
        self.engine = (
            engine if engine is not None else IncrementalStateRoot(cls, backend)
        )
        self._last: tuple | None = None  # (state, root, spec_name)

    def root(self, state, spec=None) -> bytes:
        """The engine root for ``state`` — identity-memoized so repeated
        proofs against one state object skip even the engine's own
        per-field delta checks."""
        spec = spec or get_chain_spec()
        last = self._last
        if last is not None and last[0] is state and last[2] == spec.name:
            return last[1]
        root = self.engine.root(state, spec)
        self._last = (state, root, spec.name)
        return root

    def prove(self, state, requests, spec=None) -> WitnessProof:
        """Multiproof for ``requests`` = [(field_name, element_index),
        ...] against ``state``'s root.  Duplicate requests collapse onto
        one chunk leaf (shared-sibling elimination starts at the leaf)."""
        spec = spec or get_chain_spec()
        if not requests:
            raise WitnessError("empty index set")
        if len(requests) > MAX_PROOF_INDICES:
            raise WitnessError(
                f"{len(requests)} indices exceed the per-request cap "
                f"{MAX_PROOF_INDICES}"
            )
        fields = witness_fields(self.cls, spec)
        root = self.root(state, spec)
        top_depth = _top_depth(self.cls)
        leaf_map: dict[int, tuple[FieldMeta, int]] = {}
        norm: list[tuple[str, int]] = []
        for fname, idx in requests:
            meta = fields.get(fname)
            if meta is None:
                raise WitnessError(f"field {fname!r} is not witness-enabled")
            idx = int(idx)
            n = len(getattr(state, fname))
            if not 0 <= idx < n:
                raise WitnessError(
                    f"{fname}[{idx}] out of range (length {n})"
                )
            chunk = idx // meta.per_chunk
            leaf_map[leaf_gindex(meta, chunk, top_depth)] = (meta, chunk)
            norm.append((fname, idx))
        leaves = tuple(
            (g, self._chunk_value(leaf_map[g][0], leaf_map[g][1]))
            for g in sorted(leaf_map)
        )
        helpers = helper_gindices(leaf_map.keys())
        siblings = tuple(
            self._node_value(state, g, top_depth, fields) for g in helpers
        )
        return WitnessProof(
            state_root=root,
            indices=tuple(norm),
            leaves=leaves,
            siblings=siblings,
        )

    # ------------------------------------------------------- node lookup

    def _chunk_value(self, meta: FieldMeta, chunk: int) -> bytes:
        levels = self.engine.field_levels(meta.name)
        return _subtree_node(levels, 0, chunk)

    def _node_value(self, state, g: int, top_depth: int, fields) -> bytes:
        depth = g.bit_length() - 1
        if depth <= top_depth:
            # container-level node (field roots upward): retained by root()
            return _subtree_node(
                self.engine.top_levels(), top_depth - depth, g - (1 << depth)
            )
        field_g = g >> (depth - top_depth)
        findex = field_g - (1 << top_depth)
        schema = list(self.cls.__ssz_schema__)
        if findex >= len(schema):
            # below a zero-padding leaf of the container tree
            return ZERO_HASHES[0]
        fname = schema[findex]
        meta = fields.get(fname)
        if meta is None:
            raise WitnessError(
                f"helper gindex {g} descends into non-witness field {fname!r}"
            )
        rel_depth = depth - top_depth
        rel = (1 << rel_depth) | (g & ((1 << rel_depth) - 1))
        if rel == 2:
            # the payload subtree root (the length node's sibling)
            return _subtree_node(
                self.engine.field_levels(fname), meta.depth, 0
            )
        if rel == 3:
            # the mixed-in length chunk
            return len(getattr(state, fname)).to_bytes(32, "little")
        sub_depth = rel_depth - 1
        if rel >> sub_depth != 2:
            raise WitnessError(f"gindex {g} descends under the length leaf")
        height = meta.depth - sub_depth
        if height < 0:
            raise WitnessError(f"gindex {g} below the chunk level")
        row = rel & ((1 << sub_depth) - 1)
        return _subtree_node(self.engine.field_levels(fname), height, row)
