"""Carry state across from the JAX package as SSZ bytes.

For this system the chain state plays the part that weights play for a
model: the port takes the JAX package's state as its canonical SSZ encoding
(``BeaconState.encode(spec)`` there) and decodes it into its own containers.
No object of the JAX package ever crosses.
"""

from __future__ import annotations

from . import types
from .config import ChainSpec
from .ssz import Container
from .types import deneb

__all__ = ["container_from_ssz", "state_from_ssz"]


def container_from_ssz(name: str, data: bytes, spec: ChainSpec | None = None) -> Container:
    """Decode ``data`` as the port's container class called ``name``."""
    cls = getattr(types, name, None) or getattr(deneb, name, None)
    if not (isinstance(cls, type) and issubclass(cls, Container)):
        raise KeyError(f"no container type named {name!r}")
    return cls.decode(data, spec)


def state_from_ssz(data: bytes, spec: ChainSpec | None = None) -> types.BeaconState:
    """The port's ``BeaconState`` from its SSZ bytes."""
    return types.BeaconState.decode(data, spec)
