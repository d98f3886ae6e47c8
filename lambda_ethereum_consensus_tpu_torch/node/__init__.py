"""Beacon node runtime: orchestration of every subsystem.

The analogue of the reference's OTP supervision tree (ref: lib/lambda_
ethereum_consensus/application.ex:26-45 — Telemetry, Libp2pPort, Db, Peerbook,
IncomingRequests, ForkChoice, PendingBlocks, SyncBlocks, GossipSub,
BeaconApi): a single-controller asyncio application owning the fork-choice
store, with periodic loops for ticks/pending-blocks/downloads, batched gossip
pipelines, and sidecar restart-on-crash.

The port's counterpart of the JAX package's ``node`` package:
:mod:`.node` (``BeaconNode``, ``NodeConfig``, ``TopicSpec``), :mod:`.chain`
(the live chain view req/resp answers from), :mod:`.sync` (range sync),
:mod:`.replay` (prefetched block decode), :mod:`.pending_blocks` and
:mod:`.telemetry` and :mod:`.warmup` (the boot-time warmer);
``python -m lambda_ethereum_consensus_tpu_torch.node`` boots one node on the
card.
"""

from .node import BeaconNode, NodeConfig
from .pending_blocks import PendingBlocks

__all__ = ["BeaconNode", "NodeConfig", "PendingBlocks"]
