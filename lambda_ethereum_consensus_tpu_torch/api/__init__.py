"""External HTTP interfaces: Beacon API server, Engine API client,
checkpoint-sync client (ref: lib/beacon_api/, lib/.../engine/,
lib/.../fork_choice/checkpoint_sync.ex).

The port's copy of the JAX package's ``api`` package: :mod:`.beacon_api`
(the server, on the card unless given ``device="cpu"``), :mod:`.engine`,
:mod:`.checkpoint_sync` and :mod:`.harness` (the serving fixture and the
mixed-traffic load generator)."""

from .beacon_api import BeaconApiServer

__all__ = ["BeaconApiServer"]
