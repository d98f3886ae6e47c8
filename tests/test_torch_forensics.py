"""The port's consensus forensics plane against the JAX package's.

The scenarios of the JAX package's own forensics tests run on both
packages' stores at the minimal preset: a 64-validator genesis (keys
``(i + 1).to_bytes(32, "big")``) and its blocks, minted once by the JAX
package (``tests/unit/test_fork_choice.build_block``) and carried into the
port as SSZ bytes; the port's handlers run on the plain PyTorch versions
(``device="cpu"``).  Covered: the cold-walk head audit and free memo hits,
``head_candidates``, the reorg record's depth, ancestor and attribution,
the fast-forward, the finality decomposition naming the withheld subnet,
evidence minting and dedup, the two knobs, and the handler hooks
(``update_checkpoints``, ``on_block``, ``on_attester_slashing``).
``reorgs()``, ``evidence()``, ``finality_view()``, ``forkchoice_view()``
and ``last_audit()`` are compared as dicts, whole.

Timing fields: each package's ``forensics.time`` is swapped for one fixed
clock (``time()`` returns the same instant on every read), so the ``ts``
of every record compares exactly.  Each test swaps each package's default
registry for a fresh one (kept alive for the module, so no registry id is
reused by the plane's once-per-registry bucket pinning) and compares the
forensics families it recorded: the reorg-depth and finality-lag
histograms, the participation and missing-vote gauges and the evidence and
ring-drop counters.  Tolerance: none.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lambda_ethereum_consensus_tpu import fork_choice as jfc
from lambda_ethereum_consensus_tpu import telemetry as jtelemetry
from lambda_ethereum_consensus_tpu.config import constants as jconstants
from lambda_ethereum_consensus_tpu.config import minimal_spec as jax_minimal_spec
from lambda_ethereum_consensus_tpu.config import use_chain_spec as jax_use_chain_spec
from lambda_ethereum_consensus_tpu.crypto import bls as jbls
from lambda_ethereum_consensus_tpu.fork_choice import forensics as jforensics
from lambda_ethereum_consensus_tpu.fork_choice import handlers as jhandlers
from lambda_ethereum_consensus_tpu.fork_choice.store import LatestMessage as JaxLatestMessage
from lambda_ethereum_consensus_tpu.state_transition import accessors as jacc
from lambda_ethereum_consensus_tpu.state_transition import misc as jmisc
from lambda_ethereum_consensus_tpu.state_transition.genesis import (
    build_genesis_state as jax_build_genesis_state,
)
from lambda_ethereum_consensus_tpu.types import beacon as jtypes
from lambda_ethereum_consensus_tpu_torch import convert
from lambda_ethereum_consensus_tpu_torch import fork_choice as pfc
from lambda_ethereum_consensus_tpu_torch import telemetry as ptelemetry
from lambda_ethereum_consensus_tpu_torch import types as ptypes
from lambda_ethereum_consensus_tpu_torch.config import minimal_spec, use_chain_spec
from lambda_ethereum_consensus_tpu_torch.fork_choice import forensics as pforensics
from lambda_ethereum_consensus_tpu_torch.fork_choice import handlers as phandlers
from lambda_ethereum_consensus_tpu_torch.fork_choice.store import LatestMessage

from .unit.test_fork_choice import SKS, build_block

_REGISTRIES: list = []  # every registry a test swapped in, kept alive


class _FixedClock:
    """A stand-in for the ``time`` module: one instant, every read."""

    @staticmethod
    def time() -> float:
        return 1_700_000_000.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _ambient(monkeypatch):
    monkeypatch.setenv("GRAFT_RESIDENT_EPOCH", "0")
    monkeypatch.delenv("FORENSICS_OFF", raising=False)
    monkeypatch.delenv("FORENSICS_RING_CAPACITY", raising=False)
    for telemetry, forensics in ((jtelemetry, jforensics), (ptelemetry, pforensics)):
        registry = telemetry.Metrics(enabled=True)
        _REGISTRIES.append(registry)
        monkeypatch.setattr(telemetry, "_DEFAULT", registry)
        monkeypatch.setattr(forensics, "time", _FixedClock)


def _anchor_block(types, genesis, spec):
    return types.BeaconBlock(
        slot=0,
        proposer_index=0,
        parent_root=bytes(genesis.latest_block_header.parent_root),
        state_root=genesis.hash_tree_root(spec),
        body=types.BeaconBlockBody(),
    )


@pytest.fixture(scope="module")
def chain():
    """The JAX package's genesis, anchor, blocks and one full-committee
    vote for the losing slot-1 branch."""
    spec = jax_minimal_spec()
    with jax_use_chain_spec(spec):
        genesis = jax_build_genesis_state([jbls.sk_to_pk(sk) for sk in SKS], spec=spec)
        anchor = _anchor_block(jtypes, genesis, spec)
        anchor_root = anchor.hash_tree_root(spec)
        signed_a, post_a = build_block(genesis, spec, 1, graffiti=b"\xaa" * 32)
        signed_b, _ = build_block(genesis, spec, 1, graffiti=b"\xbb" * 32)
        signed1, post1 = build_block(genesis, spec, 1)
        signed2, _ = build_block(post1, spec, 2)
        roots = {k: s.message.hash_tree_root(spec) for k, s in
                 (("a", signed_a), ("b", signed_b), ("1", signed1), ("2", signed2))}
        loser = min(roots["a"], roots["b"])
        loser_state = post_a if loser == roots["a"] else None
        if loser_state is None:
            _, loser_state = build_block(genesis, spec, 1, graffiti=b"\xbb" * 32)
        committee = jacc.get_beacon_committee(loser_state, 1, 0, spec)
        data = jtypes.AttestationData(
            slot=1, index=0, beacon_block_root=loser,
            source=jtypes.Checkpoint(epoch=0, root=anchor_root),
            target=jtypes.Checkpoint(epoch=0, root=anchor_root))
        domain = jacc.get_domain(loser_state, jconstants.DOMAIN_BEACON_ATTESTER, 0, spec)
        signing_root = jmisc.compute_signing_root(data, domain)
        vote = jtypes.Attestation(
            aggregation_bits=[True] * len(committee), data=data,
            signature=jbls.aggregate([jbls.sign(SKS[i], signing_root) for i in committee]))
        # a double vote of the first four validators at epoch 0 (a slashing)
        indexed = []
        for head in (roots["a"], roots["b"]):
            d = data.copy(beacon_block_root=head)
            root = jmisc.compute_signing_root(d, domain)
            indexed.append(jtypes.IndexedAttestation(
                attesting_indices=[0, 1, 2, 3], data=d,
                signature=jbls.aggregate([jbls.sign(SKS[i], root) for i in range(4)])))
        slashing = jtypes.AttesterSlashing(attestation_1=indexed[0], attestation_2=indexed[1])
    return dict(spec=spec, genesis=genesis, anchor=anchor, anchor_root=anchor_root,
                blocks={"a": signed_a, "b": signed_b, "1": signed1, "2": signed2},
                roots=roots, vote=vote, slashing=slashing)


class _Side:
    """One package's fork choice over the shared chain."""

    def __init__(self, name, chain):
        self.name = name
        jspec = chain["spec"]
        if name == "jax":
            self.fc, self.handlers, self.lm, self.spec = jfc, jhandlers, JaxLatestMessage, jspec
            self.genesis, self.anchor = chain["genesis"], chain["anchor"]
            self.blocks = chain["blocks"]
            self.vote, self.slashing = chain["vote"], chain["slashing"]
            self.kw = {}
            self.use_spec = jax_use_chain_spec
            self.ctx_key = (1, b"\x01" * 32)
        else:
            pspec = minimal_spec()
            self.fc, self.handlers, self.lm, self.spec = pfc, phandlers, LatestMessage, pspec
            self.genesis = convert.state_from_ssz(chain["genesis"].encode(jspec), pspec)
            with use_chain_spec(pspec):  # the empty body's sync bits take the preset's width
                self.anchor = _anchor_block(ptypes, self.genesis, pspec)
            self.blocks = {k: convert.block_from_ssz(b.encode(jspec), pspec)
                           for k, b in chain["blocks"].items()}
            self.vote = convert.container_from_ssz("Attestation", chain["vote"].encode(jspec),
                                                   pspec)
            self.slashing = convert.container_from_ssz(
                "AttesterSlashing", chain["slashing"].encode(jspec), pspec)
            self.kw = {"device": "cpu"}
            self.use_spec = use_chain_spec
            # the port keys its contexts (epoch, root, device)
            self.ctx_key = (1, b"\x01" * 32, torch.device("cpu"))

    def store(self, **kw):
        store = self.fc.get_forkchoice_store(self.genesis, self.anchor, self.spec)
        store.forensics = self.fc.ConsensusForensics(**kw)
        return store

    def tick(self, store, slot: int):
        self.fc.on_tick(store, store.genesis_time + slot * self.spec.SECONDS_PER_SLOT, self.spec)

    def block(self, store, key: str) -> bytes:
        return self.fc.on_block(store, self.blocks[key], spec=self.spec, **self.kw)

    def attest(self, store):
        self.fc.on_attestation(store, self.vote, spec=self.spec, **self.kw)

    def two_branch(self, **kw):
        store = self.store(**kw)
        self.tick(store, 2)
        return store, self.block(store, "a"), self.block(store, "b")

    def registry(self) -> dict:
        """The forensics families this package's registry recorded."""
        m = (jtelemetry if self.name == "jax" else ptelemetry).get_metrics()
        out = {}
        for name in ("reorg_depth", "finality_lag_epochs"):
            out[name] = sorted(m.histogram_series(name))
        for name in ("participation_rate", "subnet_missing_votes", "forensics_evidence_total",
                     "forensics_ring_dropped_total", "checkpoint_cache_pruned_count"):
            out[name] = sorted((k, v) for k, v in {**m._gauges, **m._counters}.items()
                               if k[0] == name)
        return out


def _both(chain, fn):
    out = {}
    for name in ("jax", "port"):
        side = _Side(name, chain)
        with side.use_spec(side.spec):
            out[name] = fn(side)
        out[name]["registry"] = side.registry()
    return out["jax"], out["port"]


# --------------------------------------------------- cold-walk head audit


def test_cold_walk_records_branch_points_and_memo_hits_stay_free(chain):
    def run(side):
        store, root_a, root_b = side.two_branch()
        head = side.fc.get_head(store, side.spec)
        appended = store.forensics.stats()["rings"]["head_audit"]["appended_total"]
        again = side.fc.get_head(store, side.spec)
        return dict(head=head, again=again, audit=store.forensics.last_audit(),
                    appended=appended,
                    after=store.forensics.stats()["rings"]["head_audit"]["appended_total"],
                    view=store.forensics.forkchoice_view(store, side.spec),
                    roots=(root_a, root_b))

    want, got = _both(chain, run)
    assert got == want
    anchor_root = chain["anchor_root"]
    assert got["audit"]["head"] == "0x" + got["head"].hex() and got["again"] == got["head"]
    (bp,) = got["audit"]["branch_points"]
    assert bp["parent"] == "0x" + anchor_root.hex()
    assert {c["root"] for c in bp["candidates"]} == {"0x" + r.hex() for r in got["roots"]}
    assert all(c["weight"] == 0 and c["boost"] == 0 for c in bp["candidates"])
    assert got["appended"] == got["after"] == 1
    assert got["view"]["head_memo"]["last_audit"] == got["audit"]
    assert len(got["view"]["nodes"]) == 3


def test_head_candidates_never_forces_a_recompute(chain):
    def run(side):
        store, _, _ = side.two_branch()
        head = side.fc.get_head(store, side.spec)
        fresh = side.fc.head_candidates(store, side.spec)
        side.attest(store)
        memo_before = store.head_memo
        stale = side.fc.head_candidates(store, side.spec)
        return dict(head=head, fresh=fresh, stale=stale,
                    memo_untouched=store.head_memo is memo_before)

    want, got = _both(chain, run)
    assert got == want
    assert got["fresh"]["fresh"] is True and got["fresh"]["head"] == "0x" + got["head"].hex()
    assert got["fresh"]["last_audit"]["head"] == "0x" + got["head"].hex()
    assert got["stale"]["fresh"] is False and got["memo_untouched"]


def test_head_candidates_without_a_plane_has_no_audit(chain):
    side = _Side("port", chain)
    with side.use_spec(side.spec):
        store = side.fc.get_forkchoice_store(side.genesis, side.anchor, side.spec)
        side.fc.get_head(store, side.spec)
        assert side.fc.head_candidates(store, side.spec)["last_audit"] is None


# ------------------------------------------------------ reorg post-mortem


def test_reorg_record_pins_depth_ancestor_and_attribution(chain):
    def run(side):
        store, root_a, root_b = side.two_branch()
        baseline = side.fc.get_head(store, side.spec)
        loser = min(root_a, root_b)
        store.forensics.note_attestation_batch(5, "cached", 3)
        store.forensics.note_block_arrival(loser, 1, 3.25)
        side.attest(store)
        flipped = side.fc.get_head(store, side.spec)
        rec = store.forensics.observe_transition(store, baseline, loser)
        rec2 = store.forensics.observe_transition(store, loser, baseline)
        return dict(baseline=baseline, loser=loser, flipped=flipped, rec=rec.to_dict(),
                    rec2=rec2.to_dict(), reorgs=store.forensics.reorgs(),
                    count=store.forensics.reorg_count(),
                    same=store.forensics.observe_transition(store, loser, loser),
                    unknown=store.forensics.observe_transition(store, b"\x13" * 32, loser))

    want, got = _both(chain, run)
    assert got == want
    assert got["baseline"] == max(chain["roots"]["a"], chain["roots"]["b"])
    assert got["flipped"] == got["loser"]
    rec = got["rec"]
    assert rec["depth"] == 1 and rec["orphaned"] == ["0x" + got["baseline"].hex()]
    assert rec["common_ancestor"] == "0x" + chain["anchor_root"].hex()
    assert rec["ancestor_slot"] == 0
    kinds = [(e["kind"], e.get("batch"), e.get("offset_s")) for e in rec["attribution"]]
    assert ("attestation_batch", 5, None) in kinds and ("block_arrival", None, 3.25) in kinds
    assert got["rec2"]["attribution"] == [] and got["count"] == 2
    assert got["same"] is None and got["unknown"] is None
    assert [s[4] for s in got["registry"]["reorg_depth"]] == [2]


def test_fast_forward_is_depth_zero_with_pinned_ancestor(chain):
    def run(side):
        store = side.store()
        side.tick(store, 3)
        root1 = side.block(store, "1")
        root2 = side.block(store, "2")
        rec = store.forensics.observe_transition(store, root1, root2)
        return dict(rec=rec.to_dict(), root1=root1, reorgs=store.forensics.reorgs())

    want, got = _both(chain, run)
    assert got == want
    assert got["rec"]["depth"] == 0 and got["rec"]["orphaned"] == []
    assert got["rec"]["common_ancestor"] == "0x" + got["root1"].hex()
    assert got["rec"]["ancestor_slot"] == 1


# ------------------------------------------------ finality decomposition


def test_finality_decomposition_names_the_withheld_subnet(chain):
    def run(side):
        spec = side.spec
        store = side.store()
        anchor_root = side.anchor.hash_tree_root(spec)
        side.tick(store, 2 * spec.SLOTS_PER_EPOCH)
        start_slot = spec.SLOTS_PER_EPOCH
        # a hand-built epoch-1 committee table (the shape the verify path
        # caches): two committees of two on the epoch's first slot
        store.attestation_contexts[side.ctx_key] = SimpleNamespace(
            committees_per_slot=2,
            lengths=np.array([2, 2], np.int64),
            start_slot=start_slot,
            committees=np.array([[0, 1], [2, 3]], np.int32),
        )
        # committee 0 voted this epoch; committee 1's votes were withheld
        store.latest_messages[0] = side.lm(epoch=1, root=anchor_root)
        store.latest_messages[1] = side.lm(epoch=1, root=anchor_root)
        rec = store.forensics.observe_epoch(store, spec)
        again = store.forensics.observe_epoch(store, spec)
        store.forensics.note_justified(1, anchor_root)
        store.forensics.note_finalized(1, anchor_root)
        return dict(rec=rec, again_is_rec=again is rec, view=store.forensics.finality_view())

    want, got = _both(chain, run)
    assert got == want
    rec = got["rec"]
    assert rec["finality_lag_epochs"] == 2 and rec["justification_lag_epochs"] == 2
    assert rec["committee_table_epoch"] == 1 and got["again_is_rec"]
    jspec = chain["spec"]
    voted, withheld = (
        str(int(jmisc.compute_subnet_for_attestation(2, jspec.SLOTS_PER_EPOCH, i, jspec)))
        for i in (0, 1))
    assert rec["subnet_missing_votes"][withheld] == 2
    assert rec["subnet_missing_votes"][voted] == 0
    assert set(rec["participation"]) == {"source", "target", "head"}
    assert [r["kind"] for r in got["view"]["history"]] == ["epoch", "justified", "finalized"]
    assert got["registry"]["subnet_missing_votes"] and got["registry"]["participation_rate"]


# --------------------------------------------------- equivocation ledger


def test_evidence_ledger_mints_and_dedups():
    def run(fc):
        plane = fc.ConsensusForensics(capacity=16)
        r1, r2 = b"\x0a" * 32, b"\x0b" * 32
        out = [plane.note_block(r1, 5, 7), plane.note_block(r1, 5, 7),
               plane.note_block(r2, 5, 7), plane.note_block(r2, 5, 7)]
        cell = (1, 9, 0, 3, b"\x33")
        out += [plane.note_vote(cell, r1), plane.note_vote(cell, r1),
                plane.note_vote(cell, r2), plane.note_vote(cell, r2)]
        plane.note_attester_slashing([3, 1])
        plane.note_attester_slashing((1, 3))  # same set, any order: deduped
        plane.note_attester_slashing([])
        counts = {k: plane.evidence_count(k)
                  for k in (None, "double_proposal", "double_vote", "attester_slashing")}
        return out, plane.evidence(), counts

    want, got = run(jfc), run(pfc)
    assert got == want
    out, evidence, counts = got
    assert out[2]["kind"] == "double_proposal" and out[6]["cell"] == [1, 9, 0, 3, "0x33"]
    assert [o is None for o in out] == [True, True, False, True, True, True, False, True]
    assert counts == {None: 3, "double_proposal": 1, "double_vote": 1, "attester_slashing": 1}
    assert [e["kind"] for e in evidence] == ["double_proposal", "double_vote",
                                             "attester_slashing"]
    assert jtelemetry.get_metrics().get("forensics_evidence_total", kind="double_vote") == \
        ptelemetry.get_metrics().get("forensics_evidence_total", kind="double_vote") == 1


def test_handler_hooks_feed_the_plane(chain):
    """``on_block`` notes every accepted block (the two slot-1 blocks share
    their proposer: a double proposal), ``on_attester_slashing`` its
    equivocators, ``update_checkpoints`` each checkpoint advance (and
    a finalized advance prunes the checkpoint caches, counted)."""
    def run(side):
        store = side.store()
        side.tick(store, 2)
        side.block(store, "a")
        side.block(store, "b")
        side.fc.on_attester_slashing(store, side.slashing, side.spec)
        anchor_root = side.anchor.hash_tree_root(side.spec)
        cp = type(store.justified_checkpoint)(epoch=1, root=anchor_root)
        side.handlers.update_checkpoints(store, cp, cp)
        return dict(evidence=store.forensics.evidence(),
                    view=store.forensics.finality_view(),
                    proposals=len(store.forensics._proposals),
                    equivocating=sorted(store.equivocating_indices))

    want, got = _both(chain, run)
    assert got == want
    assert [e["kind"] for e in got["evidence"]] == ["double_proposal", "attester_slashing"]
    assert got["evidence"][0]["roots"] == ["0x" + chain["roots"][k].hex() for k in "ab"]
    assert got["evidence"][1]["indices"] == [0, 1, 2, 3] == got["equivocating"]
    assert [r["kind"] for r in got["view"]["history"]] == ["justified", "finalized"]
    assert got["proposals"] == 1
    assert got["registry"]["checkpoint_cache_pruned_count"]


# ------------------------------------------------------------------ knobs


def test_forensics_off_knob_disables_every_organ(monkeypatch):
    monkeypatch.setenv("FORENSICS_OFF", "1")

    def run(fc, metrics):
        plane = fc.ConsensusForensics()
        enabled = plane.enabled
        plane.note_attestation_batch(1, "cached", 2)
        plane.note_block_arrival(b"\x01" * 32, 1, 0.5)
        plane.note_head_audit(1, b"\x01" * 32, [], [])
        blocks = [plane.note_block(b"\x0a" * 32, 5, 7), plane.note_block(b"\x0b" * 32, 5, 7)]
        off_stats = plane.stats()
        plane.set_enabled(True)
        plane.note_attestation_batch(1, "cached", 2)
        return enabled, blocks, off_stats, plane.stats()

    want, got = run(jfc, jtelemetry), run(pfc, ptelemetry)
    assert got == want
    enabled, blocks, off_stats, on_stats = got
    assert enabled is False and blocks == [None, None]
    assert all(r["appended_total"] == 0 for r in off_stats["rings"].values())
    assert on_stats["rings"]["weight_events"]["appended_total"] == 1


@pytest.mark.parametrize("value, capacity", [("4", 4), ("lots", 512)])
def test_ring_capacity_knob_and_drop_export(monkeypatch, value, capacity):
    monkeypatch.setenv("FORENSICS_RING_CAPACITY", value)

    def run(fc, telemetry):
        plane = fc.ConsensusForensics()
        for i in range(10):
            plane.note_attestation_batch(i, "cached", 1)
        stats = plane.stats()["rings"]["weight_events"]
        plane.export_ring_drops(telemetry.Metrics(enabled=False))
        m = telemetry.Metrics(enabled=True)
        seen = []
        for extra in (0, 0, 3):
            for i in range(extra):
                plane.note_attestation_batch(i, "cached", 1)
            plane.export_ring_drops(m)
            seen.append(m.get("forensics_ring_dropped_total", ring="weight_events"))
        return stats, seen

    want, got = run(jfc, jtelemetry), run(pfc, ptelemetry)
    assert got == want
    stats, seen = got
    assert stats["capacity"] == capacity
    if capacity == 4:
        assert stats == {"capacity": 4, "entries": 4, "appended_total": 10, "dropped_total": 6}
        assert seen == [6, 6, 9]
