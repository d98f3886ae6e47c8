"""Peer registry with scoring (ref: lib/.../p2p/peerbook.ex); the port's copy
of the JAX package's ``network/peerbook.py``.

The reference keeps ``peer_id => score`` with the score unused (init 100,
peerbook.ex:17-44); here the score actually moves — request failures penalize,
successes reward, and peers at zero are pruned.
"""

from __future__ import annotations

import random

INITIAL_SCORE = 100
MAX_SCORE = 200
PENALTY = 25
REWARD = 5


class Peerbook:
    def __init__(self, rng: random.Random | None = None):
        self._peers: dict[bytes, int] = {}
        self._rng = rng or random.Random()

    def __len__(self) -> int:
        return len(self._peers)

    def __contains__(self, peer_id: bytes) -> bool:
        return peer_id in self._peers

    def add_peer(self, peer_id: bytes) -> None:
        self._peers.setdefault(peer_id, INITIAL_SCORE)

    def remove_peer(self, peer_id: bytes) -> None:
        self._peers.pop(peer_id, None)

    def get_some_peer(self) -> bytes | None:
        """Score-weighted random peer (ref: peerbook.ex:17 random choice)."""
        if not self._peers:
            return None
        peers = list(self._peers.items())
        total = sum(score for _, score in peers)
        if total <= 0:
            return self._rng.choice([p for p, _ in peers])
        pick = self._rng.uniform(0, total)
        acc = 0.0
        for peer_id, score in peers:
            acc += score
            if pick <= acc:
                return peer_id
        return peers[-1][0]

    def reward(self, peer_id: bytes) -> None:
        if peer_id in self._peers:
            self._peers[peer_id] = min(MAX_SCORE, self._peers[peer_id] + REWARD)

    def penalize(self, peer_id: bytes) -> None:
        if peer_id in self._peers:
            self._peers[peer_id] -= PENALTY
            if self._peers[peer_id] <= 0:
                del self._peers[peer_id]
