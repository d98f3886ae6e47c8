"""The port's state transition against the JAX package, block by block.

A minimal-preset chain of 64 validators (keys ``(i + 1).to_bytes(32,
"big")``) is minted once per module by the JAX package's
``build_signed_block``: a block at slot 1, one at slot 2 carrying full
committee attestations of slot 1, and one at slot 9 past the first epoch
boundary, each with a live full-participation sync aggregate.  The port
imports the chain from its SSZ bytes with ``validate_result=True``
(``device="cpu"``: the attestation batch goes through the device chain's
plain PyTorch version), mints the same blocks byte for byte with its own
``validator.duties``, and rejects the same tampered blocks.  The JAX package
runs its host path (``GRAFT_RESIDENT_EPOCH=0`` around each of its calls).
Tolerance: none, roots and bytes are exact.

A block with attestations costs about 10 s on the CPU (the device chain's
plain version at 64-bit coefficients), so the chain is shared and short.
"""

import contextlib

import pytest
import torch

from lambda_ethereum_consensus_tpu.config import minimal_spec as jax_minimal_spec
from lambda_ethereum_consensus_tpu.config import use_chain_spec as jax_use_chain_spec
from lambda_ethereum_consensus_tpu.state_transition import StateTransitionError as JaxSTE
from lambda_ethereum_consensus_tpu.state_transition import accessors as jacc
from lambda_ethereum_consensus_tpu.state_transition import process_slots as jax_process_slots
from lambda_ethereum_consensus_tpu.state_transition import state_transition as jax_transition
from lambda_ethereum_consensus_tpu.state_transition.genesis import (
    build_genesis_state as jax_build_genesis_state,
)
from lambda_ethereum_consensus_tpu.state_transition.mutable import BeaconStateMut as JaxStateMut
from lambda_ethereum_consensus_tpu.types.beacon import Checkpoint as JaxCheckpoint
from lambda_ethereum_consensus_tpu.validator import build_signed_block as jax_build_block
from lambda_ethereum_consensus_tpu.validator import make_attestation as jax_make_attestation
from lambda_ethereum_consensus_tpu_torch import convert
from lambda_ethereum_consensus_tpu_torch.config import minimal_spec, use_chain_spec
from lambda_ethereum_consensus_tpu_torch.crypto import bls
from lambda_ethereum_consensus_tpu_torch.state_transition import (
    StateTransitionError,
    accessors,
    process_slots,
    state_transition,
)
from lambda_ethereum_consensus_tpu_torch.state_transition.genesis import build_genesis_state
from lambda_ethereum_consensus_tpu_torch.state_transition.mutable import BeaconStateMut
from lambda_ethereum_consensus_tpu_torch.types import Checkpoint, SignedBeaconBlock
from lambda_ethereum_consensus_tpu_torch.validator import (
    build_signed_block,
    make_attestation,
    sign_block,
)

N = 64
SKS = [(i + 1).to_bytes(32, "big") for i in range(N)]
SLOTS = (1, 2, 9)  # slot 2 carries slot 1's attestations; 9 crosses a boundary


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


@pytest.fixture(scope="module")
def pubkeys():
    return [bls.sk_to_pk(sk) for sk in SKS]


@pytest.fixture(scope="module")
def sync_keys(pubkeys):
    return dict(zip(pubkeys, SKS))


def _attestations(pre, slot, spec, attest, checkpoint, mutable, acc):
    """Full-committee attestations of ``slot`` on top of ``pre``."""
    ws = mutable(pre)
    epoch = slot // spec.SLOTS_PER_EPOCH
    src = pre.current_justified_checkpoint
    return [
        attest(
            ws, slot=slot, committee_index=index,
            head_root=acc.get_block_root_at_slot(ws, slot, spec),
            target=checkpoint(epoch=epoch, root=acc.get_block_root(ws, epoch, spec)),
            source=checkpoint(epoch=src.epoch, root=bytes(src.root)),
            secret_keys=SKS, spec=spec,
        )
        for index in range(acc.get_committee_count_per_slot(ws, epoch, spec))
    ]


@pytest.fixture(scope="module")
def jax_chain(specs, pubkeys, sync_keys):
    """(genesis, [signed blocks], [post states]) minted by the JAX package."""
    jspec, _ = specs
    with jax_use_chain_spec(jspec):
        genesis = jax_build_genesis_state(pubkeys, spec=jspec)
        blocks, posts, cur = [], [], genesis
        for slot in SLOTS:
            pre = jax_process_slots(cur, slot, jspec)
            atts = []
            if slot == 2:
                atts = _attestations(pre, 1, jspec, jax_make_attestation, JaxCheckpoint,
                                     JaxStateMut, jacc)
                assert len(atts) == 2
            signed, cur = jax_build_block(pre, slot, SKS, attestations=atts, spec=jspec,
                                          sync_secret_keys=sync_keys)
            blocks.append(signed)
            posts.append(cur)
    return genesis, blocks, posts


@pytest.fixture(scope="module")
def port_chain(specs, jax_chain):
    """The port's import of the JAX chain: (genesis, [blocks], [post states])."""
    jspec, pspec = specs
    genesis, blocks, _ = jax_chain
    state = convert.state_from_ssz(genesis.encode(jspec), pspec)
    ported_blocks = [convert.block_from_ssz(b.encode(jspec), pspec) for b in blocks]
    posts, cur = [], state
    with use_chain_spec(pspec):
        for signed in ported_blocks:
            cur = state_transition(cur, signed, validate_result=True, spec=pspec, device="cpu")
            posts.append(cur)
    return state, ported_blocks, posts


def test_genesis_matches_jax(specs, pubkeys, jax_chain):
    jspec, pspec = specs
    with use_chain_spec(pspec):
        genesis = build_genesis_state(pubkeys, spec=pspec)
    assert genesis.encode(pspec) == jax_chain[0].encode(jspec)
    assert genesis.hash_tree_root(pspec) == jax_chain[0].hash_tree_root(jspec)


def test_port_imports_the_jax_chain(specs, jax_chain, port_chain):
    """Every block imports with ``validate_result=True`` (its signatures and
    state root checked) and every post-state root is the JAX package's."""
    jspec, pspec = specs
    _, _, want = jax_chain
    _, blocks, got = port_chain
    assert len(blocks[1].message.body.attestations) == 2
    for g, w in zip(got, want):
        assert g.hash_tree_root(pspec) == w.hash_tree_root(jspec)
        assert g.encode(pspec) == w.encode(jspec)
    # the slot-2 block's attestations set participation flags
    assert got[1].current_epoch_participation != got[0].current_epoch_participation


def test_boundary_block_on_the_resident_plane(specs, jax_chain, port_chain, monkeypatch):
    """The slot-9 block again, with the port's plane forced on for the
    epoch boundary its slots cross."""
    jspec, pspec = specs
    _, blocks, posts = port_chain
    monkeypatch.setenv("GRAFT_RESIDENT_EPOCH", "1")
    with use_chain_spec(pspec):
        got = state_transition(posts[1], blocks[2], validate_result=True, spec=pspec,
                               device="cpu")
    monkeypatch.setenv("GRAFT_RESIDENT_EPOCH", "0")
    plane = got._resident_plane
    assert plane.stats["sweeps"] == 1 and plane.stats["fallbacks"] == 0
    assert got.hash_tree_root(pspec) == jax_chain[2][2].hash_tree_root(jspec)


def test_port_mints_the_same_blocks(specs, pubkeys, sync_keys, jax_chain):
    """The port's ``duties`` mint the JAX package's blocks byte for byte."""
    jspec, pspec = specs
    genesis, want_blocks, want_posts = jax_chain
    cur = convert.state_from_ssz(genesis.encode(jspec), pspec)
    with use_chain_spec(pspec):
        for slot, want, want_post in zip(SLOTS, want_blocks, want_posts):
            pre = process_slots(cur, slot, pspec, device="cpu")
            atts = []
            if slot == 2:
                atts = _attestations(pre, 1, pspec, make_attestation, Checkpoint,
                                     BeaconStateMut, accessors)
            signed, cur = build_signed_block(pre, slot, SKS, attestations=atts, spec=pspec,
                                             sync_secret_keys=sync_keys, device="cpu")
            assert signed.encode(pspec) == want.encode(jspec)
            assert cur.hash_tree_root(pspec) == want_post.hash_tree_root(jspec)


def _resigned(signed, pre, spec, **changes):
    """``signed``'s block with ``changes`` applied, signed again by its
    proposer, so only the change can make it invalid."""
    block = signed.message.copy(**changes)
    ws = BeaconStateMut(process_slots(pre, block.slot, spec, device="cpu"))
    return sign_block(ws, block, SKS[block.proposer_index], spec)


def _tampered(kind, port_chain, spec):
    """(pre-state, tampered block, reason) for one kind of tampering."""
    genesis, blocks, posts = port_chain
    if kind == "proposer-signature":
        bad = SignedBeaconBlock(message=blocks[0].message,
                                signature=bls.sign(SKS[0], b"\x00" * 32))
        return genesis, bad, "invalid block signature"
    if kind == "state-root":
        return genesis, _resigned(blocks[0], genesis, spec, state_root=b"\xaa" * 32), \
            "state root mismatch"
    body = blocks[1].message.body
    atts = list(body.attestations)
    # the other committee's signature: a valid G2 point that does not
    # verify for this attestation's members
    atts[0] = atts[0].copy(signature=bytes(atts[1].signature))
    return posts[0], _resigned(blocks[1], posts[0], spec, body=body.copy(attestations=atts)), \
        "invalid attestation signature"


def _jax_state(state, pspec, jspec):
    from lambda_ethereum_consensus_tpu.types.beacon import BeaconState

    return BeaconState.decode(state.encode(pspec), jspec)


def _jax_block(block, pspec, jspec):
    from lambda_ethereum_consensus_tpu.types.beacon import SignedBeaconBlock as JaxBlock

    return JaxBlock.decode(block.encode(pspec), jspec)


@pytest.mark.parametrize("kind", ["proposer-signature", "state-root", "attestation-signature"])
def test_tampered_blocks_rejected_by_both(specs, port_chain, kind):
    jspec, pspec = specs
    with use_chain_spec(pspec):
        pre, bad, reason = _tampered(kind, port_chain, pspec)
        with pytest.raises(StateTransitionError, match=reason):
            state_transition(pre, bad, validate_result=True, spec=pspec, device="cpu")
    jax_pre = _jax_state(pre, pspec, jspec)
    jax_bad = _jax_block(bad, pspec, jspec)
    with jax_use_chain_spec(jspec), pytest.raises(JaxSTE, match=reason):
        jax_transition(jax_pre, jax_bad, validate_result=True, spec=jspec)


@contextlib.contextmanager
def _no_card(monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        yield


def test_entry_points_default_to_the_card(specs, port_chain, monkeypatch):
    """``device=None`` means the card: without one, block import and
    minting raise instead of carrying on on the CPU."""
    _, pspec = specs
    genesis, blocks, _ = port_chain
    with _no_card(monkeypatch), use_chain_spec(pspec):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            state_transition(genesis, blocks[0], spec=pspec)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_signed_block(genesis, 1, SKS, spec=pspec)
