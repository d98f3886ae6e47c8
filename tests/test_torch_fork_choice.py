"""The port's fork choice against the JAX package's, handler by handler.

A minimal-preset chain of 64 validators (keys ``(i + 1).to_bytes(32,
"big")``; 2 committees of 4 per slot, so the committee cache corrects at
most ``mmax`` = 2 missing members) is minted once per module by the JAX
package's ``build_signed_block``: a block at slot 1 and one at slot 2
carrying slot 1's full-committee attestations.  Both packages then run the
same node slot from their own anchor store: ``on_tick`` to slot 3,
``on_block`` of both blocks, one ``on_attestation_batch`` drain of eight
gossip aggregates (full, one member missing, a forged signature, a sparse
aggregate over ``mmax``, a second vote of the same validators for another
root in the same epoch, another slot's committee, an unknown head block, a
bitfield of the wrong length), ``get_head``, then an attester slashing and
``get_head`` again.

The JAX package runs its host body on the CPU (its device gate is off
here).  The port runs the scenario twice, once per drain body, on the plain
PyTorch versions (``device="cpu"``), the body chosen through the drain's
threshold (``fork_choice/handlers.py`` ``DRAIN_DEVICE_MIN``) and the set
gate at its default: its host body with the threshold just above the eight
attestations (the host tail checks the prepared entries), and its cached
body with the threshold at 0 (the committee cache, the bisection over the
cached chain, the sparse host-aggregate route).  Every check runs
for both bodies against the one JAX run.  The slot-2 block goes through the
port's committee-cache branch of ``_verify_deferred_attestations``
(``operations.BLOCK_BATCH_MIN_MEMBERS`` lowered on the port side only); the
JAX package keeps its host route.  Its signature set, captured there, also
goes through each of the three routes alone (host sums on the host tail or
on the device chain, the committee cache), as imported and with two
signatures swapped.  Tolerance: none — roots, checkpoints,
verdicts with their ``reject`` polarity, latest messages and heads are
exact.

Each chained check costs several seconds on the CPU (the device chain's
plain version), so the scenario runs once per module and body and the tests
read it.
"""

import numpy as np
import pytest
import torch

from lambda_ethereum_consensus_tpu import fork_choice as jfc
from lambda_ethereum_consensus_tpu.config import constants as jconstants
from lambda_ethereum_consensus_tpu.config import minimal_spec as jax_minimal_spec
from lambda_ethereum_consensus_tpu.config import use_chain_spec as jax_use_chain_spec
from lambda_ethereum_consensus_tpu.crypto import bls as jbls
from lambda_ethereum_consensus_tpu.fork_choice import handlers as jhandlers
from lambda_ethereum_consensus_tpu.state_transition import accessors as jacc
from lambda_ethereum_consensus_tpu.state_transition import errors as jerrors
from lambda_ethereum_consensus_tpu.state_transition import misc as jmisc
from lambda_ethereum_consensus_tpu.state_transition import process_slots as jax_process_slots
from lambda_ethereum_consensus_tpu.state_transition.genesis import (
    build_genesis_state as jax_build_genesis_state,
)
from lambda_ethereum_consensus_tpu.state_transition.mutable import BeaconStateMut as JaxStateMut
from lambda_ethereum_consensus_tpu.types import beacon as jtypes
from lambda_ethereum_consensus_tpu.validator import build_signed_block as jax_build_block
from lambda_ethereum_consensus_tpu.validator import make_attestation as jax_make_attestation
from lambda_ethereum_consensus_tpu.validator.duties import sign_block as jax_sign_block
from lambda_ethereum_consensus_tpu_torch import convert
from lambda_ethereum_consensus_tpu_torch import fork_choice as pfc
from lambda_ethereum_consensus_tpu_torch import types as ptypes
from lambda_ethereum_consensus_tpu_torch.config import minimal_spec, use_chain_spec
from lambda_ethereum_consensus_tpu_torch.fork_choice import handlers as phandlers
from lambda_ethereum_consensus_tpu_torch.ops import bls_batch as BB
from lambda_ethereum_consensus_tpu_torch.state_transition import operations
from lambda_ethereum_consensus_tpu_torch.state_transition.errors import StateTransitionError
from lambda_ethereum_consensus_tpu_torch.state_transition.mutable import BeaconStateMut

N = 64
SKS = [(i + 1).to_bytes(32, "big") for i in range(N)]
TICK_SLOT = 3
# the module constant from which on_attestation_batch takes the cached body
DRAIN_CONSTANT = (phandlers, "DRAIN_DEVICE_MIN")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _host_epochs(monkeypatch):
    """Both packages read ``GRAFT_RESIDENT_EPOCH``: the JAX package always
    runs its host path here."""
    monkeypatch.setenv("GRAFT_RESIDENT_EPOCH", "0")


@pytest.fixture(scope="module")
def specs():
    return jax_minimal_spec(), minimal_spec()


def _anchor_block(types, genesis, spec):
    """The anchor block of ``genesis`` in one package's ``types``."""
    return types.BeaconBlock(
        slot=0,
        proposer_index=0,
        parent_root=bytes(genesis.latest_block_header.parent_root),
        state_root=genesis.hash_tree_root(spec),
        body=types.BeaconBlockBody(),
    )


def _signed_att(state, slot, index, head, target, source, bits, signers, spec):
    """An aggregate over ``bits`` of committee ``(slot, index)``, its
    signature by ``signers`` (the participants, or wrong keys)."""
    data = jtypes.AttestationData(slot=slot, index=index, beacon_block_root=head,
                                  source=source, target=target)
    domain = jacc.get_domain(state, jconstants.DOMAIN_BEACON_ATTESTER, target.epoch, spec)
    root = jmisc.compute_signing_root(data, domain)
    sig = jbls.aggregate([jbls.sign(SKS[v], root) for v in signers])
    return jtypes.Attestation(aggregation_bits=bits, data=data, signature=sig)


@pytest.fixture(scope="module")
def jax_chain(specs):
    """(genesis, anchor block, [signed blocks at slots 1 and 2], gossip
    drain, attester slashing), all minted by the JAX package."""
    jspec, _ = specs
    with jax_use_chain_spec(jspec):
        genesis = jax_build_genesis_state([jbls.sk_to_pk(sk) for sk in SKS], spec=jspec)
        anchor = _anchor_block(jtypes, genesis, jspec)
        anchor_root = anchor.hash_tree_root(jspec)
        pre1 = jax_process_slots(genesis, 1, jspec)
        block1, post1 = jax_build_block(pre1, 1, SKS, spec=jspec)
        pre2 = jax_process_slots(post1, 2, jspec)
        ws = JaxStateMut(pre2)
        justified = pre2.current_justified_checkpoint
        source = jtypes.Checkpoint(epoch=justified.epoch, root=bytes(justified.root))
        target = jtypes.Checkpoint(epoch=0, root=anchor_root)
        block_atts = [
            jax_make_attestation(ws, slot=1, committee_index=i,
                                 head_root=block1.message.hash_tree_root(jspec), target=target,
                                 source=source, secret_keys=SKS, spec=jspec)
            for i in range(2)
        ]
        block2, post2 = jax_build_block(pre2, 2, SKS, attestations=block_atts, spec=jspec)
        # the slot-2 block with its two attestations' signatures swapped,
        # signed again by its proposer (the state root does not hold them)
        body = block2.message.body
        swapped = [body.attestations[0].copy(signature=bytes(body.attestations[1].signature)),
                   body.attestations[1].copy(signature=bytes(body.attestations[0].signature))]
        tampered = jax_sign_block(
            pre2, block2.message.copy(body=body.copy(attestations=swapped)),
            SKS[int(block2.message.proposer_index)], jspec)
        root1 = block1.message.hash_tree_root(jspec)
        root2 = block2.message.hash_tree_root(jspec)
        c0 = list(jacc.get_beacon_committee(post2, 2, 0, jspec))
        c1 = list(jacc.get_beacon_committee(post2, 2, 1, jspec))
        c1_slot1 = list(jacc.get_beacon_committee(post2, 1, 1, jspec))
        k = len(c0)
        assert k == 4 and len(c1) == 4

        def att(slot, index, head, committee, bits, signers=None):
            part = [v for v, b in zip(committee, bits) if b]
            return _signed_att(post2, slot, index, head, target, source, bits,
                               part if signers is None else signers, jspec)

        full = [True] * k
        drain = [
            att(2, 0, root2, c0, full),                                   # accepted
            att(2, 0, root2, c0, [True] * (k - 1) + [False]),             # one missing
            att(2, 1, root2, c1, full, signers=[0] * k),                  # forged
            att(2, 1, root2, c1, [True] + [False] * (k - 1)),             # over mmax
            att(2, 0, root1, c0, full),                                   # same epoch, loses
            att(1, 1, root1, c1_slot1, full),                             # another slot
            att(2, 0, b"\x13" * 32, c0, full),                            # unknown head
            att(2, 1, root2, c1, [True] * (k + 1)),                       # bits length
        ]
        # a double vote of committee 0's members at epoch 0
        slashed = sorted(c0)
        indexed = []
        for head in (root1, root2):
            a = att(2, 0, head, c0, full)
            indexed.append(jtypes.IndexedAttestation(attesting_indices=slashed, data=a.data,
                                                     signature=a.signature))
        slashing = jtypes.AttesterSlashing(attestation_1=indexed[0], attestation_2=indexed[1])
    return dict(genesis=genesis, anchor=anchor, blocks=[block1, block2], drain=drain,
                tampered=tampered, slashing=slashing, roots=(anchor_root, root1, root2), slashed=slashed)


def _messages(store) -> dict:
    return {int(i): (int(m.epoch), bytes(m.root)) for i, m in store.latest_messages.items()}


def _verdicts(results) -> list:
    return [None if r is None else bool(r.reject) for r in results]


def _run(fc, spec, genesis, anchor, blocks, drain, slashing, **device):
    """The node slot on one package's fork choice: returns what the tests
    compare."""
    store = fc.get_forkchoice_store(genesis, anchor, spec)
    out = dict(store=store, anchor_root=fc.get_head(store, spec))
    fc.on_tick(store, store.genesis_time + TICK_SLOT * spec.SECONDS_PER_SLOT, spec)
    out["block_roots"] = [fc.on_block(store, b, spec=spec, **device) for b in blocks]
    out["post_roots"] = [store.block_states[r].hash_tree_root(spec) for r in out["block_roots"]]
    out["checkpoints"] = [
        (int(c.epoch), bytes(c.root))
        for c in (store.justified_checkpoint, store.finalized_checkpoint,
                  store.unrealized_justified_checkpoint, store.unrealized_finalized_checkpoint)
    ]
    out["verdicts"] = _verdicts(fc.on_attestation_batch(store, drain, spec=spec, **device))
    out["messages"] = _messages(store)
    out["head"] = fc.get_head(store, spec)
    out["weights"] = [fc.get_weight(store, r, spec) for r in out["block_roots"]]
    out["cache_head"] = store.head_cache.head()
    fc.on_attester_slashing(store, slashing, spec)
    out["equivocating"] = sorted(store.equivocating_indices)
    out["head_after_slashing"] = fc.get_head(store, spec)
    out["weights_after_slashing"] = [fc.get_weight(store, r, spec) for r in out["block_roots"]]
    out["cache_head_after_slashing"] = store.head_cache.head()
    return out


@pytest.fixture(scope="module")
def want(specs, jax_chain):
    """The node slot on the JAX package's fork choice (its host drain)."""
    jspec, _ = specs
    c = jax_chain
    with jax_use_chain_spec(jspec):
        return _run(jfc, jspec, c["genesis"], c["anchor"], c["blocks"], c["drain"],
                    c["slashing"])


@pytest.fixture(scope="module")
def port_runs(specs, jax_chain):
    """The node slot on the port's fork choice through one drain body, run
    once per body, chosen through the drain's threshold: ``"host"`` with it
    just above the drain, ``"cached"`` with it at 0; the set gate keeps its
    default."""
    jspec, pspec = specs
    c = jax_chain
    done = {}

    def port(data, name):
        return convert.container_from_ssz(name, data.encode(jspec), pspec)

    def run(body):
        if body in done:
            return done[body]
        genesis = convert.state_from_ssz(c["genesis"].encode(jspec), pspec)
        anchor = port(c["anchor"], "BeaconBlock")
        blocks = [convert.block_from_ssz(b.encode(jspec), pspec) for b in c["blocks"]]
        drain = [port(a, "Attestation") for a in c["drain"]]
        slashing = port(c["slashing"], "AttesterSlashing")
        mp = pytest.MonkeyPatch()
        calls, bodies, block_sets = [], [], []
        real = operations._verify_deferred_cached
        real_deferred = operations._verify_deferred_attestations

        def counted(*args):
            calls.append(len(args[1]))
            return real(*args)

        def captured(state, deferred, *args):
            block_sets.append((BeaconStateMut(state.freeze()), list(deferred)))
            return real_deferred(state, deferred, *args)

        def recorded(name):
            real_body = getattr(phandlers, name)

            def call(*args):
                bodies.append(name)
                return real_body(*args)

            mp.setattr(phandlers, name, call)

        # the slot-2 block's 8 members reach the lowered threshold: the port
        # checks them through the committee cache
        mp.setattr(operations, "BLOCK_BATCH_MIN_MEMBERS", 8)
        mp.setattr(operations, "_verify_deferred_cached", counted)
        mp.setattr(operations, "_verify_deferred_attestations", captured)
        recorded("_attestation_batch_cached")
        recorded("_attestation_batch_host")
        mp.setattr(*DRAIN_CONSTANT, 0 if body == "cached" else len(drain) + 1)
        try:
            with use_chain_spec(pspec):
                got = _run(pfc, pspec, genesis, anchor, blocks, drain, slashing,
                           device="cpu")
        finally:
            mp.undo()
        got["cached_block_calls"] = calls
        got["bodies"] = bodies
        got["block_set"] = block_sets[0]
        done[body] = got
        return got

    return run


@pytest.fixture(scope="module", params=["host", "cached"])
def runs(request, want, port_runs):
    """(the JAX package's run, the port's run through one drain body)."""
    return want, port_runs(request.param)


@pytest.fixture(scope="module")
def cached_run(want, port_runs):
    return want, port_runs("cached")


def test_blocks_import_with_equal_roots_and_checkpoints(runs):
    want, got = runs
    assert got["anchor_root"] == want["anchor_root"]
    assert got["block_roots"] == want["block_roots"]
    assert got["post_roots"] == want["post_roots"]
    assert got["checkpoints"] == want["checkpoints"]


def test_block_attestations_take_the_committee_cache_branch(runs):
    """The slot-2 block's two attestations went through the port's
    committee-cache route (and the JAX package's host route gave the same
    verdict: the block imported on both sides)."""
    _, got = runs
    assert got["cached_block_calls"] == [2]


def test_tampered_block_fails_the_committee_cache_branch(specs, jax_chain, runs):
    """The slot-2 block with two attestation signatures swapped: the
    committee-cache branch's one verdict rejects it, as the JAX package's
    host route does, and neither store takes it."""
    jspec, pspec = specs
    want, got = runs
    bad = jax_chain["tampered"]
    with jax_use_chain_spec(jspec):
        with pytest.raises(jerrors.StateTransitionError, match="invalid attestation signature"):
            jfc.on_block(want["store"], bad, spec=jspec)
    calls = []
    real = operations._verify_deferred_cached

    def counted(*args):
        calls.append(len(args[1]))
        return real(*args)

    port_bad = convert.block_from_ssz(bad.encode(jspec), pspec)
    store = got["store"]
    known = set(store.blocks)
    with pytest.MonkeyPatch.context() as mp, use_chain_spec(pspec):
        mp.setattr(operations, "BLOCK_BATCH_MIN_MEMBERS", 8)
        mp.setattr(operations, "_verify_deferred_cached", counted)
        with pytest.raises(StateTransitionError, match="invalid attestation signature"):
            pfc.on_block(store, port_bad, spec=pspec, device="cpu")
    assert calls == [2]
    assert set(store.blocks) == known


@pytest.mark.parametrize("route", ["host_tail", "device_chain", "cached"])
def test_block_signature_routes_agree(specs, cached_run, monkeypatch, route):
    """The slot-2 block's signature set through each route of
    ``_verify_deferred_attestations``, forced through the two constants:
    host sums on the host tail or on the device chain, or the committee
    cache.  Each accepts the set as imported and rejects it with its two
    signatures swapped (the JAX package's host route rejects that block)."""
    from lambda_ethereum_consensus_tpu_torch.crypto.bls import batch as B

    _, pspec = specs
    _, got = cached_run
    state, deferred = got["block_set"]
    members = sum(len(ind.attesting_indices) for _, ind, _, _ in deferred)
    monkeypatch.setattr(operations, "BLOCK_BATCH_MIN_MEMBERS",
                        0 if route == "cached" else members + 1)
    monkeypatch.setattr(B, "DEVICE_CHAIN_MIN", len(deferred) + 1 if route == "host_tail" else 0)
    seen = []

    def spy(module, name, tag):
        real = getattr(module, name)

        def call(*args, **kwargs):
            seen.append(tag)
            return real(*args, **kwargs)

        monkeypatch.setattr(module, name, call)

    spy(BB, "chain_verify", "chain_verify")
    spy(BB, "chain_verify_cached", "chain_verify_cached")
    spy(B, "_verify_points_host", "host_tail")
    (a0, i0, p0, r0), (a1, i1, p1, r1) = deferred
    swapped = [(a0, i0.copy(signature=bytes(i1.signature)), p0, r0),
               (a1, i1.copy(signature=bytes(i0.signature)), p1, r1)]
    assert operations._verify_deferred_attestations(state, deferred, pspec, "cpu") is True
    assert operations._verify_deferred_attestations(state, swapped, pspec, "cpu") is False
    want = {"host_tail": "host_tail", "device_chain": "chain_verify",
            "cached": "chain_verify_cached"}[route]
    assert seen == [want, want]


def test_cuda_and_cuda0_key_one_context(specs, jax_chain, monkeypatch):
    """``"cuda"``, ``"cuda:0"`` and ``None`` name the same card: both
    context caches hold one entry for them, on ``cuda:0``."""
    from lambda_ethereum_consensus_tpu_torch.fork_choice import attestation as FA

    jspec, pspec = specs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(FA, "_STATE_CTX", {})
    genesis = convert.state_from_ssz(jax_chain["genesis"].encode(jspec), pspec)
    card = torch.device("cuda", 0)
    with use_chain_spec(pspec):
        by_state = [FA.get_state_attestation_context(genesis, 0, pspec, d)
                    for d in ("cuda", "cuda:0", None)]
        assert all(ctx is by_state[0] for ctx in by_state) and by_state[0].device == card
        assert len(FA._STATE_CTX) == 1
        store = pfc.Store(time=0, genesis_time=0, justified_checkpoint=None,
                          finalized_checkpoint=None, unrealized_justified_checkpoint=None,
                          unrealized_finalized_checkpoint=None)
        target = ptypes.Checkpoint(epoch=0, root=jax_chain["roots"][0])
        by_store = [FA.get_attestation_context(store, target, genesis, pspec, d)
                    for d in ("cuda", "cuda:0", None)]
    assert all(ctx is by_store[0] for ctx in by_store) and by_store[0].device == card
    assert list(store.attestation_contexts) == [(0, jax_chain["roots"][0], card)]


def test_drain_verdicts_match_with_reject_polarity(runs):
    want, got = runs
    assert got["verdicts"] == want["verdicts"]
    # accepted, accepted, forged (reject), over mmax (accepted), same-epoch
    # second vote (accepted, loses the vote), another slot, unknown head
    # (ignore), wrong bitfield length (ignore)
    assert got["verdicts"] == [None, None, True, None, None, None, False, False]


def test_drain_latest_messages_and_head_match(runs, jax_chain):
    want, got = runs
    _, root1, root2 = jax_chain["roots"]
    assert got["messages"] == want["messages"]
    # within-batch ordering: committee 0's slot-2 members voted root2 first
    committee0 = jax_chain["slashed"]
    assert all(got["messages"][v] == (0, root2) for v in committee0)
    assert got["head"] == want["head"] == root2
    assert got["weights"] == want["weights"]
    assert got["cache_head"] == want["cache_head"] == got["head"]


def test_attester_slashing_matches(runs, jax_chain):
    want, got = runs
    assert got["equivocating"] == want["equivocating"] == jax_chain["slashed"]
    assert got["head_after_slashing"] == want["head_after_slashing"]
    assert got["weights_after_slashing"] == want["weights_after_slashing"]
    assert got["weights_after_slashing"][1] < got["weights"][1]
    assert got["cache_head_after_slashing"] == want["cache_head_after_slashing"]


def test_drain_took_the_body_its_constant_picks(runs, request):
    """With the drain's threshold just above its eight attestations the
    host body runs; with the threshold at 0 the cached body."""
    _, got = runs
    body = request.node.callspec.params["runs"]
    assert got["bodies"] == [f"_attestation_batch_{body}"]


def test_drain_built_one_committee_cache_on_the_cpu(cached_run):
    """The cached body really ran: one context for the drain's target, its
    committee cache built on the CPU over the chain's shared plane store."""
    _, got = cached_run
    ctxs = list(got["store"].attestation_contexts.values())
    assert len(ctxs) == 1
    cache = ctxs[0]._device_cache
    assert cache is not None and cache.device.type == "cpu" and cache.mmax == 2
    assert cache.plane_store is BB.get_plane_store(
        bytes(got["store"].block_states[got["block_roots"][0]].genesis_validators_root), "cpu")
    stats = BB.plane_store_stats()
    assert stats["stores"] >= 1 and stats["uploaded_cols"] >= N


def test_registry_planes_match(specs, jax_chain):
    """The registry's packed pubkey planes equal the JAX package's."""
    from lambda_ethereum_consensus_tpu.fork_choice.attestation import (
        registry_planes as jax_registry_planes,
    )

    jspec, pspec = specs
    genesis = jax_chain["genesis"]
    want = jax_registry_planes(genesis, jspec)
    got = pfc.registry_planes(convert.state_from_ssz(genesis.encode(jspec), pspec), pspec)
    assert got[0].shape == (32, N)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_update_latest_messages_batch_matches_per_item_ordering(specs, jax_chain):
    """The vectorized vote path reproduces the JAX package's per-item and
    batch updates on the within-batch cases: two roots at one epoch (first
    valid wins), a newer epoch later in the batch (overrides), an
    equivocating validator (ignored)."""
    jspec, pspec = specs

    class FakeCtx:
        n_validators = 8
        eff_balance = np.full(8, 32, np.int64)

    A, B, C = b"\xaa" * 32, b"\xbb" * 32, b"\xcc" * 32

    def mk(types, root, epoch):
        return types.Attestation(
            aggregation_bits=[True],
            data=types.AttestationData(slot=0, index=0, beacon_block_root=root,
                                       source=types.Checkpoint(epoch=0, root=b"\x00" * 32),
                                       target=types.Checkpoint(epoch=epoch, root=root)),
        )

    seq = [([0], A, 1), ([1], B, 1), ([1], A, 1), ([0, 2], C, 2)]

    def store_of(fc, types, spec, genesis):
        store = fc.get_forkchoice_store(genesis, _anchor_block(types, genesis, spec), spec)
        store.head_cache = None
        store.equivocating_indices.add(2)
        return store

    c = jax_chain
    with jax_use_chain_spec(jspec):
        per_item = store_of(jfc, jtypes, jspec, c["genesis"])
        for attesting, root, epoch in seq:
            jhandlers.update_latest_messages(per_item, attesting, mk(jtypes, root, epoch))
        jbatch = store_of(jfc, jtypes, jspec, c["genesis"])
        jhandlers.update_latest_messages_batch(jbatch, [
            (i, FakeCtx(), mk(jtypes, root, epoch), np.asarray(a, np.int64))
            for i, (a, root, epoch) in enumerate(seq)])
    genesis = convert.state_from_ssz(c["genesis"].encode(jspec), pspec)
    with use_chain_spec(pspec):
        pbatch = store_of(pfc, ptypes, pspec, genesis)
        phandlers.update_latest_messages_batch(pbatch, [
            (i, FakeCtx(), mk(ptypes, root, epoch), np.asarray(a, np.int64))
            for i, (a, root, epoch) in enumerate(seq)])
    assert _messages(pbatch) == _messages(per_item) == _messages(jbatch)
    assert _messages(pbatch) == {0: (2, C), 1: (1, B)}


def test_finalization_prunes_contexts_of_every_device(specs, jax_chain):
    """``prune_checkpoint_caches`` drops checkpoint states and attestation
    contexts (keyed ``(epoch, root, device)``) below the finalized epoch."""
    _, pspec = specs
    store = pfc.Store(time=0, genesis_time=0, justified_checkpoint=None,
                      finalized_checkpoint=None, unrealized_justified_checkpoint=None,
                      unrealized_finalized_checkpoint=None)
    cpu = torch.device("cpu")
    store.checkpoint_states = {(1, b"a"): 1, (3, b"b"): 2}
    store.attestation_contexts = {(1, b"a", cpu): 1, (2, b"c", cpu): 2, (3, b"b", cpu): 3}
    store.prune_checkpoint_caches(3)
    assert list(store.checkpoint_states) == [(3, b"b")]
    assert list(store.attestation_contexts) == [(3, b"b", cpu)]


def test_oldest_epoch_eviction_matches():
    """Context-cache eviction picks the same victims as the JAX package's:
    the smallest epoch, recency breaking ties, ``keep`` exempt."""
    from lambda_ethereum_consensus_tpu.fork_choice.attestation import (
        _evict_oldest_epoch as jax_evict,
    )
    from lambda_ethereum_consensus_tpu_torch.fork_choice.attestation import _evict_oldest_epoch

    keys = [(3, b"a"), (1, b"b"), (2, b"c"), (1, b"d"), (5, b"e"), (0, b"f"), (4, b"g")]
    for cap, keep in ((5, None), (3, (0, b"f")), (1, (1, b"b"))):
        got, want = dict.fromkeys(keys), dict.fromkeys(keys)
        _evict_oldest_epoch(got, cap, lambda k: k[0], keep=keep)
        jax_evict(want, cap, lambda k: k[0], keep=keep)
        assert list(got) == list(want) and len(got) == cap


def test_entry_points_resolve_the_card_first():
    """``device=None`` means the card: without one the entry points raise
    before touching the store."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pfc.on_attestation_batch(None, [], device=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pfc.on_block(None, None, device=None)
    assert pfc.on_attestation_batch(None, [], device="cpu") == []


@pytest.mark.cuda
def test_drain_on_the_card(specs, jax_chain, want, monkeypatch):
    """The same drain through the committee cache on the card (the drain's
    threshold at 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py phase 3c drives the drain "
                    "on the card")
    from lambda_ethereum_consensus_tpu_torch.ops import bigint_pallas as BP

    jspec, pspec = specs
    monkeypatch.setattr(*DRAIN_CONSTANT, 0)
    c = jax_chain
    genesis = convert.state_from_ssz(c["genesis"].encode(jspec), pspec)
    anchor = convert.container_from_ssz("BeaconBlock", c["anchor"].encode(jspec), pspec)
    blocks = [convert.block_from_ssz(b.encode(jspec), pspec) for b in c["blocks"]]
    drain = [convert.container_from_ssz("Attestation", a.encode(jspec), pspec)
             for a in c["drain"]]
    with use_chain_spec(pspec):
        store = pfc.get_forkchoice_store(genesis, anchor, pspec)
        pfc.on_tick(store, store.genesis_time + TICK_SLOT * pspec.SECONDS_PER_SLOT, pspec)
        for b in blocks:
            pfc.on_block(store, b, spec=pspec, device="cuda")
        before = dict(BP.kernel_launches)
        verdicts = _verdicts(pfc.on_attestation_batch(store, drain, spec=pspec, device="cuda"))
        assert all(BP.kernel_launches[k] > before[k] for k in before)
        assert verdicts == want["verdicts"]
        assert _messages(store) == want["messages"]
        assert pfc.get_head(store, pspec) == want["head"]
