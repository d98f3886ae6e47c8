"""Carry state across from the JAX package.

For this system the chain state plays the part that weights play for a
model: the port takes the JAX package's state, and the blocks it minted, as
their canonical SSZ encodings (``.encode(spec)`` there) and decodes them
into its own containers; a witness multiproof crosses as its compact
``encode()`` bytes.
Device-side BLS state — registry pubkey planes, committee sums, Fq12 Miller
outputs — crosses as numpy limb planes, ``(32, ...)`` int32 with 12-bit
canonical limbs, the layout both packages share.  No object of the JAX
package ever crosses.
"""

from __future__ import annotations

import numpy as np
import torch

from . import types
from .config import ChainSpec
from .ssz import Container
from .types import deneb

__all__ = [
    "block_from_ssz",
    "container_from_ssz",
    "planes_from_torch",
    "planes_to_torch",
    "state_from_ssz",
    "witness_proof_from_ssz",
]


def container_from_ssz(name: str, data: bytes, spec: ChainSpec | None = None) -> Container:
    """Decode ``data`` as the port's container class called ``name``."""
    cls = getattr(types, name, None) or getattr(deneb, name, None)
    if not (isinstance(cls, type) and issubclass(cls, Container)):
        raise KeyError(f"no container type named {name!r}")
    return cls.decode(data, spec)


def state_from_ssz(data: bytes, spec: ChainSpec | None = None) -> types.BeaconState:
    """The port's ``BeaconState`` from its SSZ bytes."""
    return types.BeaconState.decode(data, spec)


def block_from_ssz(data: bytes, spec: ChainSpec | None = None) -> types.SignedBeaconBlock:
    """The port's ``SignedBeaconBlock`` from its SSZ bytes."""
    return types.SignedBeaconBlock.decode(data, spec)


def witness_proof_from_ssz(data: bytes):
    """The port's ``WitnessProof`` from a proof's ``encode()`` bytes; raises
    ``WitnessError`` on a truncated or malformed encoding."""
    from .witness.multiproof import WitnessProof

    return WitnessProof.decode(data)


def planes_to_torch(planes, device: str | torch.device | None = None) -> torch.Tensor:
    """Numpy (or any array) limb planes ``(32, ...)`` -> an int32 tensor on
    ``device`` (default: the card)."""
    from .ops.sha256 import resolve_device

    arr = np.ascontiguousarray(np.asarray(planes), dtype=np.int32)
    if arr.ndim < 1 or arr.shape[0] != 32:
        raise ValueError(f"expected (32, ...) limb planes, got {arr.shape}")
    return torch.from_numpy(arr.copy()).to(resolve_device(device))


def planes_from_torch(t: torch.Tensor) -> np.ndarray:
    """An int32 limb-plane tensor -> numpy ``(32, ...)`` int32 on the host."""
    return t.detach().to("cpu", torch.int32).numpy()
