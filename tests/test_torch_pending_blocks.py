"""The port's pending-block scan against the JAX package's.

- The JAX package's containment regression (``tests/unit/test_pending_blocks.py``):
  an ``on_block`` that raises ``ValueError``, ``TypeError`` or ``SpecError``
  marks the block and its queued child invalid, and the scan survives.
- A small minimal-preset chain minted by the JAX package (64 validators;
  blocks at slots 1, 2 and 3, a block whose state root was tampered and
  re-signed, a child of that block, and a block whose parent is unknown),
  added child-first: both packages' scans, the port's on the plain PyTorch
  versions (``device="cpu"``), apply the same roots in the same order, mark
  the same roots invalid and queue the same parent for download.
- The data-availability gate: the slot-1 block parks until its three
  sidecars complete, then applies, in both packages.
- The port's divergence: a ``RuntimeError`` from ``on_block`` (a kernel,
  native or CUDA fault) raises out of ``process_once`` and out of the loop,
  cancels the download loop at once, counts in
  ``pending_blocks_loop_fault_total`` with a ``pending_loop_fault`` recorder
  event, and the next ``add_block()`` and ``stop()`` raise it, where the JAX
  package's loop logs it.
Tolerance: none — roots are exact.
"""

import asyncio

import pytest

from lambda_ethereum_consensus_tpu import fork_choice as jfc
from lambda_ethereum_consensus_tpu.config import minimal_spec as jax_minimal_spec
from lambda_ethereum_consensus_tpu.config import use_chain_spec as jax_use_chain_spec
from lambda_ethereum_consensus_tpu.crypto import bls as jbls
from lambda_ethereum_consensus_tpu.da import DataAvailability as JaxDataAvailability
from lambda_ethereum_consensus_tpu.node import pending_blocks as jpb
from lambda_ethereum_consensus_tpu.state_transition import process_slots as jax_process_slots
from lambda_ethereum_consensus_tpu.state_transition.genesis import (
    build_genesis_state as jax_build_genesis_state,
)
from lambda_ethereum_consensus_tpu.types import beacon as jtypes
from lambda_ethereum_consensus_tpu.validator import build_signed_block as jax_build_block
from lambda_ethereum_consensus_tpu.validator.duties import sign_block as jax_sign_block
from lambda_ethereum_consensus_tpu_torch import convert
from lambda_ethereum_consensus_tpu_torch import fork_choice as pfc
from lambda_ethereum_consensus_tpu_torch.config import minimal_spec, use_chain_spec
from lambda_ethereum_consensus_tpu_torch.da import DataAvailability
from lambda_ethereum_consensus_tpu_torch.node import PendingBlocks
from lambda_ethereum_consensus_tpu_torch import telemetry as ptel
from lambda_ethereum_consensus_tpu_torch import tracing as ptracing
from lambda_ethereum_consensus_tpu_torch.node import pending_blocks as pb_mod

N = 64
SKS = [(i + 1).to_bytes(32, "big") for i in range(N)]
TICK_SLOT = 4


# ------------------------------------------------ the containment regression

class _Msg:
    def __init__(self, root, parent, slot):
        self._root = root
        self.parent_root = parent
        self.slot = slot

    def hash_tree_root(self, spec):
        return self._root


class _Signed:
    def __init__(self, root, parent, slot=1):
        self.message = _Msg(root, parent, slot)


class _Store:
    def __init__(self, known):
        self.blocks = dict(known)


@pytest.mark.parametrize("exc", [ValueError, TypeError, pb_mod.SpecError])
def test_process_once_contains_transition_errors(monkeypatch, exc):
    parent = b"\x01" * 32
    bad_root = b"\x02" * 32
    child_root = b"\x03" * 32

    def exploding_on_block(store, signed, spec=None, device=None):
        raise exc("malformed payload")

    monkeypatch.setattr(pb_mod, "on_block", exploding_on_block)
    pb = PendingBlocks(_Store({parent: object()}), spec=None, device="cpu")
    pb.add_block(_Signed(bad_root, parent, slot=1))
    pb.add_block(_Signed(child_root, bad_root, slot=2))

    applied = asyncio.run(pb.process_once())
    assert applied == 0
    # invalid, and its queued descendant transitively invalidated
    assert bad_root in pb.invalid and child_root in pb.invalid
    assert not pb.pending


def _device_fault(store, signed, spec=None, device=None):
    raise RuntimeError(_device_fault.message)


_device_fault.message = "CUDA error: an illegal memory access was encountered"


def test_runtime_error_raises_out_of_process_once(monkeypatch):
    parent = b"\x01" * 32
    monkeypatch.setattr(pb_mod, "on_block", _device_fault)
    pb = PendingBlocks(_Store({parent: object()}), spec=None, device="cpu")
    pb.add_block(_Signed(b"\x02" * 32, parent, slot=1))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        asyncio.run(pb.process_once())
    assert pb.is_pending(b"\x02" * 32) and not pb.invalid  # neither applied nor judged


def test_runtime_error_ends_the_loop_and_stop_raises_it(monkeypatch):
    parent = b"\x01" * 32
    monkeypatch.setattr(pb_mod, "on_block", _device_fault)
    monkeypatch.setattr(pb_mod, "PROCESS_INTERVAL", 0.001)
    metrics = ptel.Metrics(enabled=True)
    monkeypatch.setattr(ptel, "_DEFAULT", metrics)
    monkeypatch.setattr(ptracing, "_RECORDER", ptracing.FlightRecorder(enabled=True))

    async def main():
        pb = PendingBlocks(_Store({parent: object()}), spec=None, device="cpu")
        pb.add_block(_Signed(b"\x02" * 32, parent, slot=1))
        with pytest.raises(RuntimeError, match="illegal memory access"):
            await asyncio.wait_for(pb._loop(pb.process_once, 0.001), timeout=5)
        pb.start()
        await asyncio.sleep(0.05)
        # the scan died and took the download loop down with it at once
        assert pb._tasks[0].done() and pb._tasks[1].cancelled()
        # the next block is refused with the fault, not parked in a dead set
        with pytest.raises(RuntimeError, match="illegal memory access"):
            pb.add_block(_Signed(b"\x03" * 32, parent, slot=2))
        assert not pb.is_pending(b"\x03" * 32)
        with pytest.raises(RuntimeError, match="illegal memory access"):
            pb.stop()
        assert pb._tasks == []

    asyncio.run(main())
    # once for the direct loop, once for the started one
    assert metrics.get("pending_blocks_loop_fault_total") == 2
    events = [ev["args"] for ev in ptracing.get_recorder().snapshot()
              if ev["name"] == "pending_loop_fault"]
    assert events == [{"error": "RuntimeError", "message": _device_fault.message}] * 2


def test_other_errors_keep_the_loop_alive(monkeypatch):
    """A non-``RuntimeError`` escaping a scan is logged and the loop goes
    on, as in the JAX package."""
    calls = []

    async def flaky():
        calls.append(1)
        raise KeyError("scan bug")

    async def main():
        for mod in (pb_mod, jpb):
            pb = mod.PendingBlocks(_Store({}), spec=None)
            task = asyncio.ensure_future(pb._loop(flaky, 0.001))
            await asyncio.sleep(0.05)
            assert not task.done()
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task

    asyncio.run(main())
    assert len(calls) > 4


# ---------------------------------------------------------------- the chain

def _anchor_block(types, genesis, spec):
    return types.BeaconBlock(
        slot=0, proposer_index=0, parent_root=bytes(genesis.latest_block_header.parent_root),
        state_root=genesis.hash_tree_root(spec), body=types.BeaconBlockBody(),
    )


@pytest.fixture(scope="module")
def chain():
    """Blocks at slots 1-3 on genesis, a slot-2 block with a tampered state
    root (re-signed), a slot-3 child of it, and a slot-3 block whose parent
    nobody has, all minted by the JAX package."""
    jspec = jax_minimal_spec()
    with jax_use_chain_spec(jspec):
        genesis = jax_build_genesis_state([jbls.sk_to_pk(sk) for sk in SKS], spec=jspec)
        anchor = _anchor_block(jtypes, genesis, jspec)
        blocks, pres, state = [], [], genesis
        for slot in (1, 2, 3):
            pres.append(jax_process_slots(state, slot, jspec))
            signed, state = jax_build_block(pres[-1], slot, SKS, spec=jspec)
            blocks.append(signed)
        tampered = jax_sign_block(
            pres[1], blocks[1].message.copy(state_root=b"\x13" * 32),
            SKS[int(blocks[1].message.proposer_index)], jspec)
        child = jtypes.SignedBeaconBlock(message=blocks[2].message.copy(
            parent_root=tampered.message.hash_tree_root(jspec)))
        orphan = jtypes.SignedBeaconBlock(message=blocks[2].message.copy(
            parent_root=b"\x42" * 32))
    # child-first arrival order
    arrivals = [blocks[2], child, orphan, tampered, blocks[1], blocks[0]]
    return dict(jspec=jspec, genesis=genesis, anchor=anchor, blocks=blocks,
                arrivals=arrivals, roots=[b.message.hash_tree_root(jspec) for b in blocks],
                tampered=tampered.message.hash_tree_root(jspec),
                child=child.message.hash_tree_root(jspec))


def _scan(name: str, chain, da_expect=None, da_sidecars=()):
    """One package's store and scan over ``chain``'s arrivals, under its
    minimal spec; returns (applied roots in order, [applied per scan],
    invalid, to_download, pending, [post-state roots])."""
    use = jax_use_chain_spec if name == "jax" else use_chain_spec
    spec = chain["jspec"] if name == "jax" else minimal_spec()
    with use(spec):
        return _scan_in(name, chain, da_expect, da_sidecars)


def _scan_in(name: str, chain, da_expect, da_sidecars):
    jspec = chain["jspec"]
    if name == "jax":
        fc, spec, gate_cls = jfc, jspec, JaxDataAvailability
        genesis, anchor, arrivals = chain["genesis"], chain["anchor"], chain["arrivals"]
        make = jpb.PendingBlocks
        kwargs = {}
    else:
        fc, spec, gate_cls = pfc, minimal_spec(), DataAvailability
        genesis = convert.state_from_ssz(chain["genesis"].encode(jspec), spec)
        anchor = convert.container_from_ssz("BeaconBlock", chain["anchor"].encode(jspec), spec)
        arrivals = [convert.block_from_ssz(b.encode(jspec), spec) for b in chain["arrivals"]]
        make = PendingBlocks
        kwargs = {"device": "cpu"}
    store = fc.get_forkchoice_store(genesis, anchor, spec)
    fc.on_tick(store, store.genesis_time + TICK_SLOT * spec.SECONDS_PER_SLOT, spec)
    applied = []
    gate = None
    if da_expect is not None:
        gate = gate_cls(spec)
        gate.expect(*da_expect)
    pb = make(store, spec, on_applied=lambda root, signed: applied.append(root),
              da_gate=gate, **kwargs)
    for b in arrivals:
        pb.add_block(b)
    per_scan = []
    for step in range(4):
        if step == 1:
            for sidecar in da_sidecars:
                gate.on_sidecar(*sidecar)
        per_scan.append(asyncio.run(pb.process_once()))
    posts = [store.block_states[r].hash_tree_root(spec) for r in applied]
    return applied, per_scan, pb.invalid, pb.to_download, set(pb.pending), posts


@pytest.fixture(autouse=True)
def _host_epochs(monkeypatch):
    monkeypatch.setenv("GRAFT_RESIDENT_EPOCH", "0")


def test_both_packages_apply_the_same_roots_in_order(chain):
    want = _scan("jax", chain)
    got = _scan("port", chain)
    assert got == want
    applied, per_scan, invalid, to_download, pending, _ = got
    assert applied == chain["roots"]
    assert per_scan == [3, 0, 0, 0]
    assert invalid == {chain["tampered"], chain["child"]}
    assert to_download == {b"\x42" * 32}
    assert pending == {chain["arrivals"][2].message.hash_tree_root(chain["jspec"])}


def test_da_gate_parks_then_applies(chain):
    comms = [bytes([i]) * 48 for i in range(1, 4)]
    root1 = chain["roots"][0]
    sidecars = [(root1, i, c) for i, c in enumerate(comms)]
    want = _scan("jax", chain, da_expect=(root1, comms), da_sidecars=sidecars)
    got = _scan("port", chain, da_expect=(root1, comms), da_sidecars=sidecars)
    assert got == want
    applied, per_scan = got[0], got[1]
    # parked on the first scan (nothing applies: every block descends from
    # slot 1), all three applied once its sidecars completed
    assert per_scan == [0, 3, 0, 0]
    assert applied == chain["roots"]
