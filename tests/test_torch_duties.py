"""The port's validator duty engine against the JAX package's, bit for bit.

A minimal-preset genesis of 64 validators (keys ``(i + 1).to_bytes(32,
"big")``, 2 committees of 4 per slot) is built by the JAX package and
carried into the port through its SSZ bytes.  Each package's
``DutyScheduler`` then derives, produces and ticks over its own copy, the
port on the CPU (``device="cpu"``, its signer on the host route:
``DUTY_SIGN_MIN`` above every flush here, since the ladder's plain version
costs seconds a flush on the CPU): the epoch duties field by field (every key, a partial
keymap, the next epoch, across a boundary that moves justification),
the votes and aggregates as SSZ bytes, the proposal's signed-block root
with an un-includable pooled attestation screened out, the pool's
aggregates and block payloads, ``on_tick`` against each package's store,
``walk_duty_epoch(256, 2)``'s counts, the four duties functions, and the
registry's duty counters.  A ``RuntimeError`` from an injected signer or
``build_signed_block`` propagates out of the port (the JAX package logs
and skips it); a ``ValueError`` is logged and skipped by both alike.  The signing
route: ``DUTY_SIGN_MIN`` at 4, flushes of 3 and 5 at 16-bit keys.
Tolerance: none, every comparison is exact.
"""

import dataclasses
import logging

import pytest
import torch

from lambda_ethereum_consensus_tpu import fork_choice as jfc
from lambda_ethereum_consensus_tpu import telemetry as JT
from lambda_ethereum_consensus_tpu.config import constants as jconstants
from lambda_ethereum_consensus_tpu.config import minimal_spec as jax_minimal_spec
from lambda_ethereum_consensus_tpu.config import use_chain_spec as jax_use_chain_spec
from lambda_ethereum_consensus_tpu.crypto import bls as jbls
from lambda_ethereum_consensus_tpu.ops import bls_sign as JS
from lambda_ethereum_consensus_tpu.state_transition import process_slots as jax_process_slots
from lambda_ethereum_consensus_tpu.state_transition.genesis import (
    build_genesis_state as jax_build_genesis_state,
)
from lambda_ethereum_consensus_tpu.state_transition.mutable import BeaconStateMut as JaxStateMut
from lambda_ethereum_consensus_tpu.tracing import SlotClock as JaxSlotClock
from lambda_ethereum_consensus_tpu.types import beacon as jtypes
from lambda_ethereum_consensus_tpu.validator import duties as jduties
from lambda_ethereum_consensus_tpu.validator import harness as jharness
from lambda_ethereum_consensus_tpu.validator import scheduler as jsched
from lambda_ethereum_consensus_tpu.validator.pool import AttestationPool as JaxPool
from lambda_ethereum_consensus_tpu_torch import convert
from lambda_ethereum_consensus_tpu_torch import fork_choice as pfc
from lambda_ethereum_consensus_tpu_torch import telemetry as PT
from lambda_ethereum_consensus_tpu_torch import types as ptypes
from lambda_ethereum_consensus_tpu_torch.config import minimal_spec, use_chain_spec
from lambda_ethereum_consensus_tpu_torch.crypto.bls import api
from lambda_ethereum_consensus_tpu_torch.ops import bls_sign as S
from lambda_ethereum_consensus_tpu_torch.state_transition import process_slots, state_transition
from lambda_ethereum_consensus_tpu_torch.tracing import SlotClock
from lambda_ethereum_consensus_tpu_torch.validator import duties as pduties
from lambda_ethereum_consensus_tpu_torch.validator import harness as pharness
from lambda_ethereum_consensus_tpu_torch.validator import scheduler as psched
from lambda_ethereum_consensus_tpu_torch.validator.pool import AttestationPool

N = 64
SKS = [(i + 1).to_bytes(32, "big") for i in range(N)]
KEYMAP = {i: SKS[i] for i in range(N)}
HEAD = b"\x08" * 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chain():
    """(JAX genesis, the port's copy, JAX spec, port spec)."""
    jspec, pspec = jax_minimal_spec(), minimal_spec()
    with jax_use_chain_spec(jspec), use_chain_spec(pspec):
        jg = jax_build_genesis_state([jbls.sk_to_pk(sk) for sk in SKS], spec=jspec)
        pg = convert.state_from_ssz(jg.encode(jspec), pspec)
        assert pg.hash_tree_root(pspec) == jg.hash_tree_root(jspec)
    return jg, pg, jspec, pspec


@pytest.fixture(autouse=True)
def _ambient(chain, monkeypatch):
    """Both ambient specs pinned, the JAX package's host epochs, the port's
    signer on the host route, and a fresh default registry in each package."""
    monkeypatch.setenv("GRAFT_RESIDENT_EPOCH", "0")
    monkeypatch.setattr(S, "DUTY_SIGN_MIN", 1 << 20)
    monkeypatch.setattr(JT, "_DEFAULT", JT.Metrics())
    monkeypatch.setattr(PT, "_DEFAULT", PT.Metrics())
    with jax_use_chain_spec(chain[2]), use_chain_spec(chain[3]):
        yield


def _schedulers(chain, keymap=KEYMAP, clock=None, sign=None):
    """One scheduler of each package; ``sign`` replaces both signers."""
    _, _, jspec, pspec = chain
    jclock = None if clock is None else JaxSlotClock(*clock)
    pclock = None if clock is None else SlotClock(*clock)
    return (jsched.DutyScheduler(keymap, jspec, clock=jclock, sign=sign or JS.sign_batch),
            psched.DutyScheduler(keymap, pspec, clock=pclock, sign=sign, device="cpu"))


def _rows(duties):
    return (duties.epoch, duties.committees_per_slot, duties.attester_count,
            {s: [dataclasses.astuple(d) for d in b] for s, b in duties.attesters_by_slot.items()},
            dict(duties.proposers))


def _ssz(objs, spec):
    return [o.encode(spec) for o in objs]


def _counters(m):
    return {
        (name, tuple(sorted(labels.items()))): m.get(name, **labels)
        for name, labels in [
            ("duties_produced_total", {"type": "attest"}),
            ("duties_produced_total", {"type": "aggregate"}),
            ("duties_produced_total", {"type": "propose"}),
            ("duty_deadline_miss_total", {"type": "attest"}),
            ("duty_deadline_miss_total", {"type": "aggregate"}),
            ("duty_signatures_total", {"path": "host"}),
            ("duty_signatures_total", {"path": "device"}),
            ("duty_pool_attestations", {}),
            ("duty_keys_managed", {}),
        ]
    }


# ------------------------------------------------------------- derivation


@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("keys", ["every", "partial"])
def test_duties_for_epoch_match_jax(chain, keys, epoch):
    jg, pg, _, _ = chain
    keymap = KEYMAP if keys == "every" else {3: SKS[3], 17: SKS[17], 999: b"\x01" * 32}
    j, p = _schedulers(chain, keymap)
    got = _rows(p.duties_for_epoch(pg, epoch))
    assert got == _rows(j.duties_for_epoch(jg, epoch))
    assert p.duties_for_epoch(pg, epoch) is p.duties_for_epoch(pg, epoch)  # cached
    if keys == "partial":
        assert {d[0] for b in got[3].values() for d in b} == {3, 17}
    else:
        assert got[2] == N


def test_cross_boundary_duties_and_votes_match_jax(chain):
    """Across an epoch boundary that moves justification, both sign the
    source and derive the proposers an epoch-advanced state answers."""
    jg, _, jspec, pspec = chain
    flag = (1 << jconstants.TIMELY_SOURCE_FLAG_INDEX) | (1 << jconstants.TIMELY_TARGET_FLAG_INDEX)
    pre = jax_process_slots(jg, 3 * jspec.SLOTS_PER_EPOCH - 1, jspec)
    ws = JaxStateMut(pre)
    for i in range(N):
        ws.previous_epoch_participation[i] = flag
        ws.current_epoch_participation[i] = flag
    jhead = ws.freeze()
    phead = convert.state_from_ssz(jhead.encode(jspec), pspec)
    boundary = 3 * jspec.SLOTS_PER_EPOCH
    advanced = process_slots(phead, boundary, pspec, "cpu")
    assert advanced.current_justified_checkpoint != phead.current_justified_checkpoint
    j, p = _schedulers(chain)
    votes = p.produce_attestations(phead, boundary, b"\x0a" * 32)
    assert votes and votes[0].data.source == advanced.current_justified_checkpoint
    assert _ssz(votes, pspec) == _ssz(j.produce_attestations(jhead, boundary, b"\x0a" * 32),
                                      jspec)
    assert _rows(p.duties_for_epoch(phead, 3)) == _rows(j.duties_for_epoch(jhead, 3))


@pytest.mark.parametrize("total", [1, 7, 300, 5000])
def test_proposer_sampling_matches_jax(chain, total):
    """The port shuffles each proposer candidate alone; the JAX package
    reads them off the whole permutation.  Low balances force rejections."""
    from lambda_ethereum_consensus_tpu.state_transition import misc as jmisc
    from lambda_ethereum_consensus_tpu_torch.state_transition import misc as pmisc

    _, _, jspec, pspec = chain
    ebs = [(i * 7919 % 33) * 10**9 for i in range(total + 3)]
    indices = list(range(3, total + 3))
    for k in range(6):
        seed = pmisc.hash_bytes(b"proposer seed %d" % k)
        assert pmisc.compute_proposer_index(ebs, indices, seed, pspec) == \
            jmisc.compute_proposer_index(ebs, indices, seed, jspec), (total, k)


# ------------------------------------------------------------- production


def test_attestations_and_aggregates_match_jax(chain):
    jg, pg, jspec, pspec = chain
    clock = (0, int(pspec.SECONDS_PER_SLOT), 3)
    j, p = _schedulers(chain, clock=clock)
    third = pspec.SECONDS_PER_SLOT / 3
    for slot in range(1, pspec.SLOTS_PER_EPOCH):
        start = p.clock.slot_start(slot)
        # the last slot fires a full slot late: every duty a miss on both
        late = pspec.SECONDS_PER_SLOT if slot == pspec.SLOTS_PER_EPOCH - 1 else 0
        pv = p.produce_attestations(pg, slot, HEAD, now=start + third + late)
        jv = j.produce_attestations(jg, slot, HEAD, now=start + third + late)
        assert pv and _ssz(pv, pspec) == _ssz(jv, jspec), slot
        pa = p.produce_aggregates(pg, slot, now=start + 2 * third)
        ja = j.produce_aggregates(jg, slot, now=start + 2 * third)
        assert pa and _ssz(pa, pspec) == _ssz(ja, jspec), slot
    assert len(p.pool) == len(j.pool)
    got = _counters(PT.get_metrics())
    assert got == _counters(JT.get_metrics())
    assert got[("duty_deadline_miss_total", (("type", "attest"),))] > 0
    assert got[("duty_signatures_total", (("path", "device"),))] == 0


def test_produce_block_screens_unincludable_attestation_like_jax(chain):
    jg, pg, jspec, pspec = chain
    j, p = _schedulers(chain)
    head = pg.latest_block_header.copy(state_root=pg.hash_tree_root(pspec)).hash_tree_root(pspec)
    assert _ssz(p.produce_attestations(pg, 1, head), pspec) == \
        _ssz(j.produce_attestations(jg, 1, head), jspec)
    for types, sched, bls in ((jtypes, j, jbls), (ptypes, p, api)):
        sched.pool.add_aggregate(types.Attestation(
            aggregation_bits=[True] + [False] * 3,
            data=types.AttestationData(
                slot=1, index=0, beacon_block_root=head,
                source=types.Checkpoint(epoch=5, root=b"\x66" * 32),  # bogus
                target=types.Checkpoint(epoch=0, root=head)),
            signature=bls.G2_POINT_AT_INFINITY))
    psigned, ppost = p.produce_block(pg, 2)
    jsigned, jpost = j.produce_block(jg, 2)
    assert psigned.message.hash_tree_root(pspec) == jsigned.message.hash_tree_root(jspec)
    assert psigned.encode(pspec) == jsigned.encode(jspec)
    assert ppost.hash_tree_root(pspec) == jpost.hash_tree_root(jspec)
    sources = {(int(a.data.source.epoch), bytes(a.data.source.root))
               for a in psigned.message.body.attestations}
    assert psigned.message.body.attestations and (5, b"\x66" * 32) not in sources
    state_transition(pg, psigned, validate_result=True, spec=pspec, device="cpu")
    assert p.produce_block(ppost, 2) is None and j.produce_block(jpost, 2) is None


# ------------------------------------------------------------------- pool


def _pool_script(types, bls, pool, genesis, spec):
    def data_at(slot, root, index=0):
        return types.AttestationData(slot=slot, index=index, beacon_block_root=root,
                                     source=types.Checkpoint(),
                                     target=types.Checkpoint(epoch=0, root=root))

    def vote(data, size, pos, sig=None):
        bits = [False] * size
        bits[pos] = True
        return types.Attestation(aggregation_bits=bits, data=data,
                                 signature=bls.G2_POINT_AT_INFINITY if sig is None else sig)

    added = []
    wide, narrow = data_at(1, b"\x01" * 32), data_at(1, b"\x02" * 32)
    for pos in range(3):
        added.append(pool.add_vote(vote(wide, 4, pos, bls.sign(SKS[pos], b"wide"))))
    added.append(pool.add_vote(vote(wide, 4, 0)))  # first seen wins
    added.append(pool.add_vote(vote(narrow, 4, 0, bls.sign(SKS[9], b"narrow"))))
    added.append(pool.add_vote(vote(data_at(1, b"\x04" * 32, index=1), 4, 2)))
    added.append(pool.add_vote(vote(data_at(2, b"\x03" * 32), 4, 0)))  # not includable at 2
    with pytest.raises(ValueError) as exc:
        pool.add_vote(types.Attestation(aggregation_bits=[True, True, False, False], data=wide))
    before = (pool.aggregate_for(1, 0), pool.aggregate_for(1, 1), pool.aggregate_for(3, 0),
              pool.block_attestations(2), pool.block_attestations(2, max_count=1))
    pool.add_aggregate(types.Attestation(aggregation_bits=[True, True, False, False],
                                         data=narrow, signature=b"\x02" * 96))
    after = pool.block_attestations(2)
    enc = [None if a is None else a.encode(spec) for a in before[:3]]
    enc += [[a.encode(spec) for a in seq] for seq in (*before[3:], after)]
    pruned = (pool.prune(2), len(pool), pool.prune(1 + spec.SLOTS_PER_EPOCH + 3), len(pool))
    return added, str(exc.value), enc, pruned


def test_pool_aggregates_and_block_payloads_match_jax(chain):
    jg, pg, jspec, pspec = chain
    got = _pool_script(ptypes, api, AttestationPool(pspec), pg, pspec)
    assert got == _pool_script(jtypes, jbls, JaxPool(jspec), jg, jspec)
    assert got[0] == [True, True, True, False, True, True, True]
    assert got[2][0] is not None and got[2][2] is None
    assert PT.get_metrics().get("duty_pool_attestations") == \
        JT.get_metrics().get("duty_pool_attestations") == 0


# ------------------------------------------------------------------- tick


def _anchor(types, genesis, spec):
    return types.BeaconBlock(slot=0, proposer_index=0,
                             parent_root=bytes(genesis.latest_block_header.parent_root),
                             state_root=genesis.hash_tree_root(spec), body=types.BeaconBlockBody())


def _produced(produced, spec):
    out = {}
    for key, value in produced.items():
        if key == "block":
            signed, post = value
            out[key] = (signed.encode(spec), post.hash_tree_root(spec))
        elif key == "committees_per_slot":
            out[key] = value
        else:
            out[key] = _ssz(value, spec)
    return out


def _ticked(chain, sign=None):
    """Both schedulers ticked 2/3 into slot 1 against their own store, then
    again half a second later."""
    jg, pg, jspec, pspec = chain
    jstore = jfc.get_forkchoice_store(jg, _anchor(jtypes, jg, jspec), jspec)
    pstore = pfc.get_forkchoice_store(pg, _anchor(ptypes, pg, pspec), pspec)
    jfc.on_tick(jstore, jstore.genesis_time + jspec.SECONDS_PER_SLOT, jspec)
    pfc.on_tick(pstore, pstore.genesis_time + pspec.SECONDS_PER_SLOT, pspec)
    j, p = _schedulers(chain, clock=(int(pstore.genesis_time), int(pspec.SECONDS_PER_SLOT), 3),
                       sign=sign)
    now = p.clock.slot_start(1) + 2 * pspec.SECONDS_PER_SLOT / 3 + 0.1
    return (j, jstore, now), (p, pstore, now)


def test_on_tick_matches_jax(chain):
    _, _, jspec, pspec = chain
    (j, jstore, now), (p, pstore, _) = _ticked(chain)
    got = _produced(p.on_tick(pstore, now=now), pspec)
    assert got == _produced(j.on_tick(jstore, now=now), jspec)
    assert set(got) == {"attestations", "committees_per_slot", "block", "aggregates"}
    assert got["attestations"] and got["aggregates"]
    assert p.on_tick(pstore, now=now + 0.5) == {} == j.on_tick(jstore, now=now + 0.5)
    assert _counters(PT.get_metrics()) == _counters(JT.get_metrics())


def _raising(cls):
    def sign(secret_keys, messages):
        raise cls("injected signer fault")

    return sign


def test_on_tick_fault_handling(chain, caplog):
    (j, jstore, now), (p, pstore, _) = _ticked(chain, sign=_raising(RuntimeError))
    with pytest.raises(RuntimeError, match="injected signer fault"):
        p.on_tick(pstore, now=now)
    # the JAX package logs and skips even a device fault
    assert j.on_tick(jstore, now=now) == {}
    (j, jstore, now), (p, pstore, _) = _ticked(chain, sign=_raising(ValueError))
    caplog.clear()
    with caplog.at_level(logging.ERROR, logger="duties"):
        assert p.on_tick(pstore, now=now) == {} == j.on_tick(jstore, now=now)
    assert [r.getMessage() for r in caplog.records] == ["duty phase failed at slot 1"] * 2


@pytest.mark.parametrize("cls", [RuntimeError, ValueError])
def test_produce_block_rebuild_only_for_bad_candidates(chain, cls, monkeypatch):
    """A ``build_signed_block`` that fails with pooled attestations: a ``ValueError`` is a
    bad candidate, rebuilt without them as the JAX package does; a
    ``RuntimeError`` is a fault and propagates from the port."""
    jg, pg, jspec, pspec = chain
    j, p = _schedulers(chain)
    head = pg.latest_block_header.copy(state_root=pg.hash_tree_root(pspec)).hash_tree_root(pspec)
    p.produce_attestations(pg, 1, head)
    j.produce_attestations(jg, 1, head)
    for module in (jsched, psched):
        real = module.build_signed_block

        def build(*args, _real=real, **kwargs):
            if kwargs.get("attestations"):
                raise cls("injected build fault")
            return _real(*args, **kwargs)

        monkeypatch.setattr(module, "build_signed_block", build)
    jsigned, _ = j.produce_block(jg, 2)
    assert not jsigned.message.body.attestations
    if cls is RuntimeError:
        with pytest.raises(RuntimeError, match="injected build fault"):
            p.produce_block(pg, 2)
    else:
        psigned, _ = p.produce_block(pg, 2)
        assert psigned.encode(pspec) == jsigned.encode(jspec)


def test_walk_duty_epoch_matches_jax():
    p = pharness.walk_duty_epoch(256, 2, device="cpu")
    j = jharness.walk_duty_epoch(256, 2)
    assert set(p) == set(j)
    p.pop("wall_s"), j.pop("wall_s")
    assert p == j
    assert p["attested"] == 16 and p["aggregated"] > 0 and p["deadline_misses"] == 0


# ---------------------------------------------------- the duties functions


def test_duties_functions_match_jax(chain):
    jg, pg, jspec, pspec = chain
    for slot in (0, 1, 9):
        for sk in (SKS[0], SKS[33]):
            got = pduties.get_slot_signature(pg, slot, sk, pspec)
            assert got == jduties.get_slot_signature(jg, slot, sk, jspec)
            for index in (0, 1):
                assert pduties.is_aggregator(pg, slot, index, got, pspec) == \
                    jduties.is_aggregator(jg, slot, index, got, jspec)
    proofs = [api.sign(SKS[i], b"selection %d" % i) for i in range(24)]
    lotteries = []
    for length in (0, 1, 15, 16, 31, 32, 100, 128, 512, 2048):
        for proof in proofs:
            got = pduties.is_aggregator_hash(proof, length)
            assert got == jduties.is_aggregator_hash(proof, length), length
            lotteries.append(got)
    assert True in lotteries and False in lotteries
    j, p = _schedulers(chain)
    pvote = p.produce_attestations(pg, 3, HEAD)[0]
    jvote = j.produce_attestations(jg, 3, HEAD)[0]
    v = pvote.aggregation_bits.index(True)
    got = pduties.build_aggregate_and_proof(pg, 7, pvote, SKS[v], pspec)
    assert got.encode(pspec) == \
        jduties.build_aggregate_and_proof(jg, 7, jvote, SKS[v], jspec).encode(jspec)


# ----------------------------------------------------------- the sign route


def test_sign_route_by_duty_sign_min(monkeypatch):
    monkeypatch.setattr(S, "DUTY_SIGN_MIN", 4)
    calls = []
    for name in ("_sign_points_device", "_sign_points_host"):
        real = getattr(S, name)

        def spy(*args, _name=name, _real=real, **kwargs):
            calls.append((_name, len(args[0])))
            return _real(*args, **kwargs)

        monkeypatch.setattr(S, name, spy)
    sks = [(i + 3).to_bytes(32, "big") for i in range(5)]
    msgs = [b"route-%d" % (i % 2) for i in range(5)]
    for n in (3, 5):
        got = S.sign_batch(sks[:n], msgs[:n], device="cpu", nbits=16)
        assert got == [api.sign(sk, m) for sk, m in zip(sks[:n], msgs[:n])], n
        assert got == JS.sign_batch(sks[:n], msgs[:n], device=False), n
    assert calls == [("_sign_points_host", 3), ("_sign_points_device", 5)]
    m = PT.get_metrics()
    assert (m.get("duty_signatures_total", path="host"),
            m.get("duty_signatures_total", path="device")) == (3, 5)
    assert m.get_histogram("duty_sign_seconds")[3] == 2
    # the device is resolved first on both sides of the gate
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for n in (3, 5):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            S.sign_batch(sks[:n], msgs[:n], nbits=16)
    assert len(calls) == 2


def test_ladder_fault_propagates_out_of_sign_batch(monkeypatch):
    monkeypatch.setattr(S, "DUTY_SIGN_MIN", 0)

    def ladder(*args):
        raise RuntimeError("injected ladder fault")

    monkeypatch.setattr(S, "g2_ladder", ladder)
    with pytest.raises(RuntimeError, match="injected ladder fault"):
        S.sign_batch([(5).to_bytes(32, "big")], [b"m"], device="cpu")
    assert PT.get_metrics().get("duty_signatures_total", path="device") == 0
