"""Chain specification: runtime-swappable constants (ref: lib/chain_spec/chain_spec.ex:6-9).

The reference selects a config module via application env and reads constants
with ``ChainSpec.get("SLOTS_PER_EPOCH")``; spec tests hot-swap the config per
test module (ref: lib/mix/tasks/generate_spec_tests.ex:57-59).  Here a
:class:`ChainSpec` is an immutable constants bag; the active spec is held in a
context variable so tests and per-request code can swap it locally with
:func:`use_chain_spec` without mutating global state.
"""

from __future__ import annotations

import contextlib
import contextvars
import re
from typing import Any, Iterator, Mapping

from . import constants  # re-export: fixed spec constants
from .presets import CONFIGS, merged_preset

__all__ = [
    "ChainSpec",
    "constants",
    "get_chain_spec",
    "set_chain_spec",
    "use_chain_spec",
    "mainnet_spec",
    "minimal_spec",
    "load_config_file",
]


class ChainSpec(Mapping):
    """An immutable mapping of chain constants: preset ⊕ config overlay.

    Attribute access (``spec.SLOTS_PER_EPOCH``) and mapping access
    (``spec["SLOTS_PER_EPOCH"]``) are both supported, mirroring the
    reference's ``ChainSpec.get/1`` (lib/chain_spec/chain_spec.ex:6-9).
    """

    __slots__ = ("_table", "name")

    def __init__(self, name: str, table: Mapping[str, Any]):
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "_table", dict(table))

    # -- mapping protocol
    def __getitem__(self, key: str) -> Any:
        return self._table[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._table)

    def __len__(self) -> int:
        return len(self._table)

    def __getattr__(self, key: str) -> Any:
        try:
            return self._table[key]
        except KeyError:
            raise AttributeError(key) from None

    def __setattr__(self, key: str, value: Any) -> None:
        raise TypeError("ChainSpec is immutable")

    def __repr__(self) -> str:
        return f"ChainSpec({self.name!r}, {len(self._table)} constants)"

    def get(self, key: str, default: Any = None) -> Any:
        return self._table.get(key, default)

    def replace(self, **overrides: Any) -> "ChainSpec":
        table = dict(self._table)
        table.update(overrides)
        return ChainSpec(self.name, table)

    # -- derived helpers used across the consensus core
    def fork_version_at_epoch(self, epoch: int) -> bytes:
        """Version of the active fork at ``epoch`` (deneb-aware)."""
        if epoch >= self.DENEB_FORK_EPOCH:
            return self.DENEB_FORK_VERSION
        if epoch >= self.CAPELLA_FORK_EPOCH:
            return self.CAPELLA_FORK_VERSION
        if epoch >= self.BELLATRIX_FORK_EPOCH:
            return self.BELLATRIX_FORK_VERSION
        if epoch >= self.ALTAIR_FORK_EPOCH:
            return self.ALTAIR_FORK_VERSION
        return self.GENESIS_FORK_VERSION

    def fork_at_epoch(self, epoch: int) -> str:
        if epoch >= self.DENEB_FORK_EPOCH:
            return "deneb"
        if epoch >= self.CAPELLA_FORK_EPOCH:
            return "capella"
        if epoch >= self.BELLATRIX_FORK_EPOCH:
            return "bellatrix"
        if epoch >= self.ALTAIR_FORK_EPOCH:
            return "altair"
        return "phase0"


def _build(name: str) -> ChainSpec:
    table = merged_preset(CONFIGS[name]["PRESET_BASE"])
    table.update(CONFIGS[name])
    return ChainSpec(name, table)


_MAINNET = _build("mainnet")
_MINIMAL = _build("minimal")


def mainnet_spec() -> ChainSpec:
    return _MAINNET


def minimal_spec() -> ChainSpec:
    return _MINIMAL


_active: contextvars.ContextVar[ChainSpec] = contextvars.ContextVar(
    "active_chain_spec", default=_MAINNET
)


def get_chain_spec() -> ChainSpec:
    """The process-wide active spec (default: mainnet)."""
    return _active.get()


def set_chain_spec(spec: ChainSpec | str) -> None:
    if isinstance(spec, str):
        spec = _build(spec)
    _active.set(spec)


@contextlib.contextmanager
def use_chain_spec(spec: ChainSpec | str):
    """Locally swap the active spec (how spec-test modules select configs)."""
    if isinstance(spec, str):
        spec = _build(spec)
    token = _active.set(spec)
    try:
        yield spec
    finally:
        _active.reset(token)


def _decode_value(v: Any) -> Any:
    """YAML scalar → spec value; 0x-hex strings become bytes (ref: lib/utils/config.ex:13-17)."""
    if isinstance(v, str) and v.startswith("0x"):
        return bytes.fromhex(v[2:])
    if isinstance(v, str) and v.isdigit():
        return int(v)
    return v


# PyYAML implements YAML 1.1, which resolves unquoted `0x...` scalars to int —
# losing the byte-string meaning of fork versions / hashes / addresses. Quote
# them before parsing so _decode_value sees the hex text.
_HEX_SCALAR = re.compile(r"^(\s*[A-Za-z_0-9]+\s*:\s*)(0x[0-9a-fA-F]+)\s*(#.*)?$")


def _quote_hex_scalars(text: str) -> str:
    out = []
    for line in text.splitlines():
        m = _HEX_SCALAR.match(line)
        out.append(f"{m.group(1)}'{m.group(2)}'" if m else line)
    return "\n".join(out)


def load_config_file(path: str, base: str | None = None) -> ChainSpec:
    """Load a runtime config YAML overlay, as the reference's ConfigUtils does
    (ref: lib/utils/config.ex:7-26): values override the named base preset's
    merged table; ``PRESET_BASE`` in the file selects the preset when ``base``
    is not given.
    """
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(_quote_hex_scalars(f.read())) or {}
    decoded = {k: _decode_value(v) for k, v in raw.items()}
    preset = base or decoded.get("PRESET_BASE", "mainnet")
    table = merged_preset(preset)
    table.update(CONFIGS.get(preset, {}))
    table.update(decoded)
    return ChainSpec(decoded.get("CONFIG_NAME", preset), table)
