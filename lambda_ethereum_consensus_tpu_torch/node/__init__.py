"""The node's ingest path below the wire: pending-block tracking with its
data-availability gate.

The port's counterpart of the JAX package's ``node`` package, so far only
:mod:`.pending_blocks`.  It does not import a ``BeaconNode``: the node
itself (``node.py``, with its gossip handlers, range sync, replay and
warm-up) is not ported yet.
"""

from .pending_blocks import PendingBlocks

__all__ = ["PendingBlocks"]
