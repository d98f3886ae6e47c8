"""Networking: sidecar process, host port, gossip pipeline, req/resp.

The port's copy of the JAX package's bespoke wire: a separate sidecar
process (``sidecar.py``) speaking a length-framed protobuf control protocol
over stdio, the host's :class:`Port` that drives it, the batched gossip
pipeline (``gossip.py``) and the eth2 req/resp protocols (``reqresp.py``).
None of it does device work; the gossip handlers reach the card.

This module imports only :mod:`.port`, which imports no ``torch``: the
sidecar process loads it.  ``gossip`` (which needs ``torch`` through
``state_transition.misc``) and ``reqresp`` are imported by name.
"""

from .port import Port, PortError

__all__ = ["Port", "PortError"]
