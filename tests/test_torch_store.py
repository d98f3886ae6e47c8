"""The port's crash-safe store against the JAX package's.

- One seeded sequence of puts, deletes, overwrites and a compaction writes
  byte-equal WAL files through the JAX package's Python engine, the port's
  Python engine and the port's native engine (``native/kvstore/kvstore.cpp``
  built with ``g++`` into the port's ``_build/``; the JAX package's native
  engine is never used here, since it loads only ``native/build/``).
- The crash cases of ``tests/unit/test_store.py`` — a torn tail, a record
  sheared mid-frame, a torn header, a CRC-caught bit flip, a legacy
  unframed log migrated on open — run on both port engines, each held to
  the JAX Python engine's recovery report and contents on the same bytes.
- A WAL written by either package opens in the other, framed, migrated and
  compacted.
- The typed stores: a block and a state written by one package read back
  by the other, the verified resume returning the same root and state, and
  rejecting a state whose bytes no longer root to the block's
  ``state_root``.
- ``KvStore(native=None)`` loads the engine from the port's ``_build/`` and
  never reads ``native/build/``.
Tolerance: none — bytes, recovery reports and roots are exact.
"""

import ctypes
import os
import struct

import numpy as np
import pytest

from lambda_ethereum_consensus_tpu.config import minimal_spec as jax_minimal_spec
from lambda_ethereum_consensus_tpu.config import use_chain_spec as jax_use_chain_spec
from lambda_ethereum_consensus_tpu.crypto import bls as jbls
from lambda_ethereum_consensus_tpu.state_transition.genesis import (
    build_genesis_state as jax_build_genesis_state,
)
from lambda_ethereum_consensus_tpu.store import BlockStore as JaxBlockStore
from lambda_ethereum_consensus_tpu.store import StateStore as JaxStateStore
from lambda_ethereum_consensus_tpu.store import kv as jkv
from lambda_ethereum_consensus_tpu.types import beacon as jtypes
from lambda_ethereum_consensus_tpu_torch import convert
from lambda_ethereum_consensus_tpu_torch.config import minimal_spec
from lambda_ethereum_consensus_tpu_torch.ops import _build
from lambda_ethereum_consensus_tpu_torch.store import (
    BlockStore,
    KvError,
    KvStore,
    StateStore,
    get_finalized_anchor,
    set_finalized_anchor,
)
from lambda_ethereum_consensus_tpu_torch.store import kv as pkv

ENGINES = {"python": False, "native": True}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _native_built():
    """The port's native engine, built into ``_build/`` (skipped without
    ``g++``)."""
    try:
        _build.cxx_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    pkv._native_lib()


def _jax_kv(path):
    return jkv.KvStore(path, native=False, durability="finality")


def _port_kv(path, engine):
    return KvStore(path, native=ENGINES[engine])


def _legacy_record(op: int, key: bytes, val: bytes) -> bytes:
    return bytes([op]) + struct.pack("<II", len(key), len(val)) + key + val


def _ops(seed: int) -> list:
    rng = np.random.default_rng(seed)
    keys = [bytes(rng.integers(0, 256, int(rng.integers(1, 24)), dtype=np.uint8))
            for _ in range(24)]
    ops = []
    for step in range(300):
        key = keys[int(rng.integers(0, len(keys)))]
        r = rng.random()
        if r < 0.7:
            ops.append(("put", key, bytes(rng.integers(0, 256, int(rng.integers(0, 300)),
                                                       dtype=np.uint8))))
        elif r < 0.95:
            ops.append(("delete", key))
        else:
            ops.append(("flush",))
        if step == 200:
            ops.append(("compact",))
    return ops


def _apply(kv, ops) -> dict:
    for op, *args in ops:
        getattr(kv, op)(*args)
    kv.sync()
    out = dict(kv.iterate())
    assert kv.count() == len(out)
    kv.close()
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_ops_write_byte_equal_wals(tmp_path, seed):
    ops = _ops(seed)
    contents = {"jax": _apply(_jax_kv(str(tmp_path / "jax.wal")), ops)}
    for engine in ENGINES:
        contents[engine] = _apply(_port_kv(str(tmp_path / f"{engine}.wal"), engine), ops)
    wal = (tmp_path / "jax.wal").read_bytes()
    assert wal[:8] == pkv.WAL_HEADER == jkv.WAL_HEADER
    for engine in ENGINES:
        assert (tmp_path / f"{engine}.wal").read_bytes() == wal, engine
        assert contents[engine] == contents["jax"]


def test_crc32c_matches_the_jax_package():
    rng = np.random.default_rng(7)
    for n in (0, 1, 9, 64, 1000):
        data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        assert pkv.crc32c(data) == jkv.crc32c(data)
        assert pkv._frame(1, b"k", data) == jkv._frame(1, b"k", data)


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _recovered(kv) -> tuple:
    rec = dict(kv.recovery)
    got = dict(kv.iterate())
    kv.close()
    return rec, got


def _crash_case(tmp_path, name: str, write, damage) -> None:
    """``write(kv)`` through the JAX Python engine, ``damage(path)`` the
    file, then reopen the same bytes in the JAX Python engine and in both
    port engines: the recovery reports, contents and repaired files must
    agree, and a second open must be clean."""
    base = str(tmp_path / f"{name}.wal")
    if write is not None:
        kv = _jax_kv(base)
        write(kv)
        kv.sync()
        kv.close()
    damage(base)
    raw = _read(base)
    paths = {who: str(tmp_path / f"{name}-{who}.wal") for who in ("jax", *ENGINES)}
    for path in paths.values():
        with open(path, "wb") as f:
            f.write(raw)
    want = _recovered(_jax_kv(paths["jax"]))
    repaired = _read(paths["jax"])
    for engine in ENGINES:
        got = _recovered(_port_kv(paths[engine], engine))
        assert got == want, engine
        assert _read(paths[engine]) == repaired, engine
        again = _port_kv(paths[engine], engine)
        assert again.recovery["truncated"] is False and again.recovery["migrated"] is False
        assert dict(again.iterate()) == want[1]
        again.close()


def _two_records(kv):
    kv.put(b"keep", b"me")
    kv.put(b"gone", b"x" * 64)


def _truncate_by(cut):
    def damage(path):
        os.truncate(path, os.path.getsize(path) - cut)
    return damage


def _append(data):
    def damage(path):
        with open(path, "ab") as f:
            f.write(data)
    return damage


def _flip(path):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size - 3)
        byte = f.read(1)[0]
        f.seek(size - 3)
        f.write(bytes([byte ^ 0x01]))


def _rewrite(data):
    def damage(path):
        with open(path, "wb") as f:
            f.write(data)
    return damage


CRASHES = {
    "torn tail": (_two_records, _append(b"\x01\xff\xff")),
    "partial record 1": (_two_records, _truncate_by(1)),
    "partial record 5": (_two_records, _truncate_by(5)),
    "partial record 12": (_two_records, _truncate_by(12)),
    "partial record 14": (_two_records, _truncate_by(14)),
    "torn header 4": (None, _rewrite(jkv.WAL_HEADER[:4])),
    "torn header 7": (None, _rewrite(jkv.WAL_HEADER[:7])),
    "zero-length log": (None, _rewrite(b"")),
    "crc bit flip": (_two_records, _flip),
    "legacy log": (None, _rewrite(
        _legacy_record(1, b"old", b"data") + _legacy_record(1, b"gone", b"soon")
        + _legacy_record(2, b"gone", b"") + b"\x01\x03\x00")),
}


@pytest.mark.parametrize("case", sorted(CRASHES))
def test_crash_recovery_agrees(tmp_path, case):
    write, damage = CRASHES[case]
    _crash_case(tmp_path, case.replace(" ", "_"), write, damage)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_wal_opens_across_packages(tmp_path, engine):
    """Legacy → migrated by the JAX package → written by the port →
    compacted by the port → read by the JAX package, and back."""
    path = str(tmp_path / "interchange.wal")
    with open(path, "wb") as f:
        f.write(_legacy_record(1, b"seed", b"legacy"))
    a = _jax_kv(path)
    assert a.recovery["migrated"] is True
    a.put(b"from", b"jax")
    a.sync()
    a.close()
    b = _port_kv(path, engine)
    assert (b.get(b"seed"), b.get(b"from")) == (b"legacy", b"jax")
    b.put(b"and", b"port")
    b.delete(b"seed")
    b.compact()
    b.close()
    c = _jax_kv(path)
    assert c.recovery["truncated"] is False
    assert dict(c.iterate()) == {b"from": b"jax", b"and": b"port"}
    c.put(b"last", b"jax")
    c.sync()
    c.close()
    d = _port_kv(path, engine)
    assert dict(d.iterate()) == {b"from": b"jax", b"and": b"port", b"last": b"jax"}
    d.close()


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_durability_barrier_and_anchor(tmp_path, engine):
    from lambda_ethereum_consensus_tpu_torch import telemetry as ptel

    assert pkv.DEFAULT_DURABILITY == "finality"
    with pytest.raises(KvError):
        KvStore(str(tmp_path / "knob.wal"), native=ENGINES[engine], durability="sometimes")
    kv = _port_kv(str(tmp_path / "anchor.wal"), engine)
    assert kv.durability == "finality"
    assert get_finalized_anchor(kv) is None
    set_finalized_anchor(kv, b"\xaa" * 32)
    before = ptel.get_metrics().get("storage_fsync_total", reason="finality")
    kv.barrier()
    assert ptel.get_metrics().get("storage_fsync_total", reason="finality") == before + 1
    assert get_finalized_anchor(kv) == b"\xaa" * 32
    kv.put(b"finalized|anchor", b"short")
    assert get_finalized_anchor(kv) is None
    kv.close()


# ------------------------------------------------------------ typed stores

@pytest.fixture(scope="module")
def chain():
    """A 16-validator minimal-preset genesis and a block committing to its
    root, minted by the JAX package; the port's copies through SSZ."""
    jspec, pspec = jax_minimal_spec(), minimal_spec()
    sks = [(i + 1).to_bytes(32, "big") for i in range(16)]
    with jax_use_chain_spec(jspec):
        state = jax_build_genesis_state([jbls.sk_to_pk(sk) for sk in sks], spec=jspec)
        signed = jtypes.SignedBeaconBlock(message=jtypes.BeaconBlock(
            slot=5, state_root=state.hash_tree_root(jspec), body=jtypes.BeaconBlockBody()))
    return dict(
        jspec=jspec, pspec=pspec, jstate=state, jblock=signed,
        pstate=convert.state_from_ssz(state.encode(jspec), pspec),
        pblock=convert.block_from_ssz(signed.encode(jspec), pspec),
    )


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_typed_stores_round_trip_across_packages(tmp_path, chain, engine):
    jspec, pspec = chain["jspec"], chain["pspec"]
    path = str(tmp_path / "chain.wal")
    kv = _port_kv(path, engine)
    root = BlockStore(kv).store_block(chain["pblock"], pspec)
    StateStore(kv).store_state(root, chain["pstate"], pspec)
    kv.barrier()
    kv.close()
    assert root == chain["jblock"].message.hash_tree_root(jspec)

    jax = _jax_kv(path)
    jblocks, jstates = JaxBlockStore(jax), JaxStateStore(jax)
    assert jblocks.get_block(root, jspec).encode(jspec) == chain["jblock"].encode(jspec)
    got = jstates.get_latest_verified_state(jblocks, jspec)
    assert got is not None and got[0] == root
    assert got[1].encode(jspec) == chain["jstate"].encode(jspec)
    jax.close()

    kv = _port_kv(path, engine)
    blocks, states = BlockStore(kv), StateStore(kv)
    assert blocks.has_block(root) and states.has_state(root)
    assert blocks.get_block_by_slot(5, pspec).message.hash_tree_root(pspec) == root
    assert blocks.highest_slot() == 5
    assert blocks.missing_slots(3, 8) == [3, 4, 6, 7]
    assert list(blocks.stored_slots()) == [5]
    latest = states.get_latest_state(pspec)
    assert latest[0] == root and latest[1].encode(pspec) == chain["pstate"].encode(pspec)
    got = states.get_latest_verified_state(blocks, pspec)
    assert got[0] == root
    assert got[1].hash_tree_root(pspec) == chain["jstate"].hash_tree_root(jspec)
    kv.close()


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_verified_resume_rejects_corrupt_state(tmp_path, chain, engine):
    """A state record whose bytes no longer root to the stored block's
    ``state_root`` is rejected by both packages, counted by reason."""
    from lambda_ethereum_consensus_tpu_torch import telemetry as ptel

    jspec, pspec = chain["jspec"], chain["pspec"]
    path = str(tmp_path / "verify.wal")
    kv = _port_kv(path, engine)
    blocks, states = BlockStore(kv), StateStore(kv)
    root = blocks.store_block(chain["pblock"], pspec)
    states.store_state(root, chain["pstate"], pspec)
    assert states.verified_state(root, blocks, pspec) is not None
    raw = bytearray(kv.get(b"beacon_state|" + root))
    raw[50] ^= 0xFF
    kv.put(b"beacon_state|" + root, bytes(raw))
    before = ptel.get_metrics().get("storage_resume_rejected_total", reason="root")
    assert states.verified_state(root, blocks, pspec) is None
    assert states.get_latest_verified_state(blocks, pspec) is None
    assert ptel.get_metrics().get("storage_resume_rejected_total", reason="root") == before + 2
    kv.put(b"beacon_state|" + root, bytes(raw[:40]))  # undecodable
    assert states.verified_state(root, blocks, pspec) is None
    kv.sync()
    kv.close()
    jax = _jax_kv(path)
    assert JaxStateStore(jax).get_latest_verified_state(JaxBlockStore(jax), jspec) is None
    jax.close()


def test_native_engine_loads_only_from_the_port_build(tmp_path, monkeypatch):
    """``KvStore(native=None)`` builds and loads ``_build/libkvstore-*.so``;
    it opens no path under ``native/build/``, even when a library sits
    there: here a decoy ``native/build/libkvstore.so`` (bytes no loader
    accepts) beside a copy of ``native/kvstore/kvstore.cpp`` that the build
    table is pointed at."""
    decoy = tmp_path / "decoy"
    (decoy / "native" / "kvstore").mkdir(parents=True)
    (decoy / "native" / "build").mkdir()
    src = decoy / "native" / "kvstore" / "kvstore.cpp"
    src.write_bytes(_build.HOST_SOURCES["kvstore"].read_bytes())
    (decoy / "native" / "build" / "libkvstore.so").write_bytes(b"not a library")
    monkeypatch.setitem(_build.HOST_SOURCES, "kvstore", src)
    loaded, opened = [], []
    real_cdll, real_exists = ctypes.CDLL, os.path.exists

    def cdll(path, *args, **kwargs):
        loaded.append(str(path))
        return real_cdll(path, *args, **kwargs)

    def exists(path):
        opened.append(str(path))
        return real_exists(path)

    monkeypatch.setattr(pkv, "_NATIVE", None)
    monkeypatch.setattr(pkv.ctypes, "CDLL", cdll)
    monkeypatch.setattr(os.path, "exists", exists)
    kv = KvStore(str(tmp_path / "default.wal"))
    assert kv.native is True
    kv.put(b"k", b"v")
    kv.close()
    assert len(loaded) == 1
    assert os.path.dirname(loaded[0]) == str(_build.BUILD_DIR)
    assert os.path.basename(loaded[0]).startswith("libkvstore-")
    for build_dir in (os.path.join(REPO, "native", "build"), str(decoy / "native" / "build")):
        assert not any(p.startswith(build_dir) for p in loaded + opened)


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """A compiler failure raises from ``KvStore(native=None)``: no quiet
    switch to the Python engine."""
    def failing(name="bls381"):
        raise RuntimeError(f"host build of {name} failed: g++ exited 1")

    monkeypatch.setattr(pkv, "_NATIVE", None)
    monkeypatch.setattr(pkv._build, "build_host", failing)
    with pytest.raises(RuntimeError, match="g\\+\\+ exited 1"):
        KvStore(str(tmp_path / "nobuild.wal"))
    assert not os.path.exists(tmp_path / "nobuild.wal")
    kv = KvStore(str(tmp_path / "python.wal"), native=False)
    assert kv.native is False
    kv.close()
