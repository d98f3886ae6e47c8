"""Public SSZ API, mirroring the reference's `Ssz` module surface
(ref: lib/ssz.ex:8-90 — ``to_ssz/1``, ``from_ssz/2``, ``list_from_ssz/2``,
``hash_tree_root/1``, ``hash_tree_root_list/2``) plus the hashing-backend
controls that make Merkleization dispatchable to the CUDA kernel.
"""

from __future__ import annotations

from .bitfields import Bitlist as BitlistValue
from .bitfields import Bits, Bitvector as BitvectorValue
from .core import (
    Bitlist,
    Bitvector,
    Boolean,
    ByteList,
    ByteVector,
    Container,
    List,
    SSZError,
    SSZType,
    Uint,
    Vector,
    boolean,
    merkleize_chunks,
    mix_in_length,
    pack_bytes,
    uint8,
    uint16,
    uint32,
    uint64,
    uint128,
    uint256,
)
from .hash import (
    ZERO_HASHES,
    HashBackend,
    HashlibBackend,
    get_hash_backend,
    hash_pair,
    set_hash_backend,
    sha256,
)

__all__ = [
    # descriptor types
    "SSZType", "Uint", "Boolean", "ByteVector", "ByteList", "Vector", "List",
    "Bitvector", "Bitlist", "Container",
    "uint8", "uint16", "uint32", "uint64", "uint128", "uint256", "boolean",
    # value types
    "Bits", "BitvectorValue", "BitlistValue",
    # engine
    "SSZError", "merkleize_chunks", "mix_in_length", "pack_bytes",
    "ZERO_HASHES", "HashBackend", "HashlibBackend",
    "get_hash_backend", "set_hash_backend", "sha256", "hash_pair",
    # Ssz-module-style API
    "to_ssz", "from_ssz", "list_from_ssz", "hash_tree_root", "hash_tree_root_list",
]


def to_ssz(value: Container, spec=None) -> bytes:
    """Serialize a container value (ref: Ssz.to_ssz/1, lib/ssz.ex:8)."""
    return type(value).serialize(value, spec)


def from_ssz(data: bytes, typ, spec=None):
    """Deserialize ``data`` as ``typ`` (ref: Ssz.from_ssz/2, lib/ssz.ex:30)."""
    from .core import _typ

    return _typ(typ).deserialize(data, spec)


def list_from_ssz(data: bytes, elem_typ, limit=None, spec=None):
    """Deserialize an SSZ list body of ``elem_typ`` elements
    (ref: Ssz.list_from_ssz/2, lib/ssz.ex:45)."""
    from .core import List as _List, _typ

    limit = limit if limit is not None else 2**63
    return _List(_typ(elem_typ), limit).deserialize(data, spec)


def hash_tree_root(value, typ=None, spec=None, backend=None) -> bytes:
    """Merkle root of an SSZ value (ref: Ssz.hash_tree_root/1, lib/ssz.ex:70)."""
    from .core import _typ

    if typ is None:
        if not isinstance(value, Container):
            raise TypeError("typ required for non-container values")
        typ = type(value)
    return _typ(typ).hash_tree_root(value, spec, backend)


def hash_tree_root_list(values, elem_typ, limit, spec=None, backend=None) -> bytes:
    """Root of ``List[elem_typ, limit]`` (ref: Ssz.hash_tree_root_list/2, lib/ssz.ex:80)."""
    from .core import List as _List, _typ

    return _List(_typ(elem_typ), limit).hash_tree_root(values, spec, backend)
