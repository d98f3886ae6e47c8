"""The port's SSZ codec and containers against the JAX package's, bit for bit.

Every container is built from a seed in the JAX package's types, encoded
there, decoded and re-encoded by the port; both packages' roots must agree.
"""

import numpy as np
import pytest

from lambda_ethereum_consensus_tpu import ssz as jssz
from lambda_ethereum_consensus_tpu.config import minimal_spec as jax_minimal_spec
from lambda_ethereum_consensus_tpu.ssz.core import _resolve, _typ
from lambda_ethereum_consensus_tpu.types import beacon as jbeacon
from lambda_ethereum_consensus_tpu.types import deneb as jdeneb
from lambda_ethereum_consensus_tpu.types import p2p as jp2p
from lambda_ethereum_consensus_tpu.types import validator as jvalidator
from lambda_ethereum_consensus_tpu_torch import convert
from lambda_ethereum_consensus_tpu_torch import ssz as pssz
from lambda_ethereum_consensus_tpu_torch.config import minimal_spec as port_minimal_spec


def random_value(typ, spec, rng, lengths=None, max_list=3):
    """A seeded value of JAX-package SSZ type ``typ``; every list holds at
    least one element.  ``lengths`` maps a container field name to the exact
    length its list should have."""
    lengths = lengths or {}
    t = _typ(typ)
    if isinstance(t, jssz.Uint):
        return int.from_bytes(rng.bytes(t.size), "little")
    if isinstance(t, jssz.Boolean):
        return bool(rng.integers(2))
    if isinstance(t, jssz.ByteVector):
        return rng.bytes(_resolve(t.length, spec))
    if isinstance(t, jssz.ByteList):
        return rng.bytes(int(rng.integers(1, min(_resolve(t.limit, spec), 40) + 1)))
    if isinstance(t, jssz.Bitvector):
        return jssz.BitvectorValue.from_bools(rng.integers(2, size=_resolve(t.length, spec)))
    if isinstance(t, jssz.Bitlist):
        n = int(rng.integers(1, min(_resolve(t.limit, spec), 20) + 1))
        return jssz.BitlistValue.from_bools(rng.integers(2, size=n))
    if isinstance(t, jssz.Vector):
        return [random_value(t.elem, spec, rng) for _ in range(_resolve(t.length, spec))]
    if isinstance(t, jssz.List):
        n = int(rng.integers(1, min(_resolve(t.limit, spec), max_list) + 1))
        return [random_value(t.elem, spec, rng) for _ in range(n)]
    cls = t.cls  # a container
    fields = {}
    for name, ftype in cls.__ssz_schema__.items():
        ft = _typ(ftype)
        if name in lengths:
            fields[name] = [random_value(ft.elem, spec, rng) for _ in range(lengths[name])]
        else:
            fields[name] = random_value(ft, spec, rng)
    return cls(**fields)


def _containers(module):
    return [
        (module.__name__.rsplit(".", 1)[1], name)
        for name, obj in vars(module).items()
        if isinstance(obj, type)
        and issubclass(obj, jssz.Container)
        and obj.__module__ == module.__name__
    ]


_MODULES = {"beacon": jbeacon, "deneb": jdeneb, "p2p": jp2p, "validator": jvalidator}
_CASES = [c for m in _MODULES.values() for c in _containers(m)]


def test_every_container_is_covered():
    from lambda_ethereum_consensus_tpu_torch import types as ptypes
    from lambda_ethereum_consensus_tpu_torch.types import deneb as pdeneb

    assert len(_CASES) >= 40
    for module, name in _CASES:
        port_cls = getattr(ptypes, name, None) or getattr(pdeneb, name)
        jax_cls = getattr(_MODULES[module], name)
        assert list(port_cls.__ssz_schema__) == list(jax_cls.__ssz_schema__), name


@pytest.mark.parametrize("filled", [True, False], ids=["seeded", "default"])
@pytest.mark.parametrize("module,name", _CASES)
def test_container_roundtrip_and_root(minimal, module, name, filled):
    jspec, pspec = minimal, port_minimal_spec()
    jax_cls = getattr(_MODULES[module], name)
    rng = np.random.default_rng(sum(map(ord, name)))
    value = random_value(jax_cls, jspec, rng) if filled else jax_cls()
    wire = value.encode(jspec)
    ported = convert.container_from_ssz(name, wire, pspec)
    assert type(ported).__module__.startswith("lambda_ethereum_consensus_tpu_torch.")
    assert ported.encode(pspec) == wire
    assert ported.hash_tree_root(pspec) == value.hash_tree_root(jspec)


def test_convert_rejects_unknown_name():
    with pytest.raises(KeyError):
        convert.container_from_ssz("NotAContainer", b"", port_minimal_spec())


def test_decode_errors_match():
    """Malformed bytes raise the port's SSZError where the JAX package raises its own."""
    pspec = port_minimal_spec()
    wire = jbeacon.Checkpoint(epoch=3, root=b"\x01" * 32).encode(jax_minimal_spec())
    for bad in (wire[:-1], wire + b"\x00"):
        with pytest.raises(jssz.SSZError):
            jbeacon.Checkpoint.decode(bad, jax_minimal_spec())
        with pytest.raises(pssz.SSZError):
            convert.container_from_ssz("Checkpoint", bad, pspec)


def test_config_file_overlay_matches_jax(tmp_path):
    """``load_config_file`` (YAML imported lazily) builds the same spec in both packages."""
    from lambda_ethereum_consensus_tpu.config import load_config_file as jax_load
    from lambda_ethereum_consensus_tpu_torch.config import load_config_file as port_load

    path = tmp_path / "devnet.yaml"
    path.write_text(
        "PRESET_BASE: minimal\nCONFIG_NAME: devnet\nSECONDS_PER_SLOT: 3\n"
        "GENESIS_FORK_VERSION: 0x10000038\n"
    )
    port, jax = port_load(str(path)), jax_load(str(path))
    assert port.name == jax.name == "devnet"
    assert dict(port) == dict(jax)
    assert port.GENESIS_FORK_VERSION == bytes.fromhex("10000038")
