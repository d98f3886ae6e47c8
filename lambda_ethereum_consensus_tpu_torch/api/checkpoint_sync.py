"""Checkpoint sync: fetch a finalized state from a trusted beacon API
(ref: lib/.../fork_choice/checkpoint_sync.ex:14-40).

``GET <url>/eth/v2/debug/beacon/states/finalized`` as ``application/
octet-stream`` -> SSZ-decode a ``BeaconState``.  Runs in a thread so the
asyncio node loop is not blocked.

The port's copy of the JAX package's ``api/checkpoint_sync.py``, decoding
with the port's ``BeaconState.decode``.  :class:`CheckpointSyncError`
derives from :class:`~..faults.WireError` (still a ``RuntimeError``), so a
peer that cannot serve the state is never read as a fault of the card.
The caller roots the state it gets (on the card through
:class:`~..ops.sha256.DeviceHashBackend`) and compares it with the
finalized block's ``state_root``.
"""

from __future__ import annotations

import asyncio
import urllib.error
import urllib.request

from ..config import ChainSpec, get_chain_spec
from ..faults import WireError
from ..types.beacon import BeaconState

FINALIZED_STATE_PATH = "/eth/v2/debug/beacon/states/finalized"


class CheckpointSyncError(WireError):
    """The finalized state could not be fetched or did not decode."""


def fetch_finalized_state(base_url: str, spec: ChainSpec | None = None, timeout: float = 60.0) -> BeaconState:
    spec = spec or get_chain_spec()
    url = base_url.rstrip("/") + FINALIZED_STATE_PATH
    req = urllib.request.Request(
        url, headers={"Accept": "application/octet-stream"}
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read()
    except (urllib.error.URLError, OSError) as e:
        raise CheckpointSyncError(f"checkpoint fetch failed: {e}") from None
    try:
        return BeaconState.decode(raw, spec)
    except ValueError as e:
        raise CheckpointSyncError(f"invalid checkpoint state: {e}") from None


async def sync_from_checkpoint(base_url: str, spec: ChainSpec | None = None) -> BeaconState:
    return await asyncio.get_running_loop().run_in_executor(
        None, fetch_finalized_state, base_url, spec or get_chain_spec()
    )
