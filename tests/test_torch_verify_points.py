"""The port's signature-set verification against the JAX package and the
host oracle.

``verify_points``, ``batch_verify_each_points`` (bisection blame with one
and two bad entries and with a ``None`` point) and ``batch_verify`` over
bytes.  The port runs each check as a chained device verify on the CPU
(the field kernels' plain versions) at 16-bit coefficients, its size gate
``DEVICE_CHAIN_MIN`` set to 0 so that these small sets take the device
route (``tests/test_torch_size_routes.py`` holds the routes on both sides
of the gate), each chained call on the composed pairing tail
(``DEVICE_TAIL_MIN`` at 0) and the single sets also on the hybrid one; the JAX package's verdicts come from its CPU route (below its
device-chain size gate, the host RLC).  RLC coefficients are random, so verdicts are compared,
not packed checks.  Tolerance: none, verdicts are exact.
"""

import secrets

import pytest
import torch

from lambda_ethereum_consensus_tpu.crypto.bls import batch as JB
from lambda_ethereum_consensus_tpu_torch.crypto import bls
from lambda_ethereum_consensus_tpu_torch.crypto.bls import batch as B
from lambda_ethereum_consensus_tpu_torch.crypto.bls import curve as C
from lambda_ethereum_consensus_tpu_torch.crypto.bls.fields import R
from lambda_ethereum_consensus_tpu_torch.crypto.bls.hash_to_curve import DST_POP, hash_to_g2
from lambda_ethereum_consensus_tpu_torch.ops import bls_batch as BB
from lambda_ethereum_consensus_tpu_torch.ops import bls_pairing as BPair

MSGS = [b"verify-points-a", b"verify-points-b"]
BITS = 16
SKS = [7 + 11 * i for i in range(4)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the pairing tail's constant for each case: at 0 every chained call takes
# the composed tail, at 64 these one- and two-check calls the hybrid one
TAIL_MIN = {"constant-0": 0, "constant-0-hybrid-tail": 64}


@pytest.fixture(params=list(TAIL_MIN))
def chain_min(request, monkeypatch):
    """The set gate's constant for a case: at 0 every set takes the chained
    device route, its tail as ``TAIL_MIN`` puts it."""
    monkeypatch.setattr(B, "DEVICE_CHAIN_MIN", 0)
    monkeypatch.setattr(BPair, "DEVICE_TAIL_MIN", TAIL_MIN[request.param])
    return 0


@pytest.fixture(scope="module")
def memo():
    return {(m, DST_POP): hash_to_g2(m, DST_POP) for m in MSGS}


def _entries(memo, bad=()):
    """Four (pk, message, sig) entries over two messages; entries in ``bad``
    are signed by the wrong key."""
    out = []
    for i, sk in enumerate(SKS):
        msg = MSGS[i % 2]
        sig = C.g2.multiply_raw(memo[(msg, DST_POP)], sk + 1 if i in bad else sk)
        out.append((C.g1.multiply_raw(C.G1_GENERATOR, sk), msg, sig))
    return out


def test_verify_points_matches_jax_and_host(memo, chain_min):
    good, bad = _entries(memo), _entries(memo, bad=(2,))
    for entries, want in ((good, True), (bad, False)):
        got = B.verify_points(entries, message_points=dict(memo), device="cpu", coeff_bits=BITS)
        assert got == JB.verify_points(entries) == want
        assert B.verify_points(entries, message_points=dict(memo), coeff_bits=BITS,
                               host=True) == want
    # the RLC scaling through the batched ladders equals the host products
    coeffs = [secrets.randbits(BITS) | 1 for _ in good]
    pks, sigs = B._scale_entries(good, coeffs, BITS, "cpu")
    assert pks == [C.g1.multiply_raw(pk, r) for (pk, _, _), r in zip(good, coeffs)]
    assert sigs == [C.g2.multiply_raw(sig, r) for (_, _, sig), r in zip(good, coeffs)]
    # None points and empty batches never reach the device
    with_none = good[:2] + [(None, MSGS[0], good[2][2])]
    assert B.verify_points(with_none) is JB.verify_points(with_none) is False
    assert B.verify_points([]) is JB.verify_points([]) is True


@pytest.mark.parametrize(
    "bad, none_at, levels",
    [
        ((2,), None, [1, 2, 2]),
        ((1, 2), None, [1, 2, 4]),
        ((), 3, [1, 1]),
    ],
    ids=["one-bad", "two-bad", "none-point"],
)
@pytest.mark.parametrize("chain_min", ["constant-0"], indirect=True)  # the composed tail
def test_batch_verify_each_points_blame_matches_jax(memo, monkeypatch, chain_min, bad, none_at,
                                                     levels):
    entries = _entries(memo, bad)
    if none_at is not None:
        entries[none_at] = (None, entries[none_at][1], entries[none_at][2])
    want = [i not in bad and i != none_at for i in range(len(entries))]
    assert JB.batch_verify_each_points(entries) == want
    calls = []
    real = BB.chain_verify

    def spy(checks, device, coeff_bits):
        calls.append(len(checks))
        return real(checks, device, coeff_bits)

    monkeypatch.setattr(BB, "chain_verify", spy)
    got = B.batch_verify_each_points(entries, message_points=dict(memo), device="cpu",
                                     coeff_bits=BITS)
    assert got == want
    # level-synchronous: each bisection level's live ranges in one call
    assert calls == levels


def test_batch_verify_bytes_matches_jax(chain_min):
    from lambda_ethereum_consensus_tpu.crypto import bls as jbls

    sks = [(secrets.randbelow(R - 1) + 1).to_bytes(32, "big") for _ in range(3)]
    items = [(bls.sk_to_pk(sk), MSGS[i % 2], bls.sign(sk, MSGS[i % 2])) for i, sk in enumerate(sks)]
    assert bls.batch_verify(items, device="cpu", coeff_bits=BITS) is True
    assert jbls.batch_verify(items) is True
    forged = list(items)
    forged[1] = (items[1][0], items[1][1], items[0][2])  # another key's signature
    assert bls.batch_verify(forged, device="cpu", coeff_bits=BITS) is False
    assert jbls.batch_verify(forged) is False
    # undecodable bytes reject without a check
    junk = [(items[0][0], MSGS[0], b"\xff" * 96)]
    assert bls.batch_verify(junk) is jbls.batch_verify(junk) is False
    assert bls.batch_verify([]) is True


def test_entry_points_default_to_the_card(memo, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    entries = _entries(memo)[:1]
    for call in (
        lambda: B.verify_points(entries, message_points=dict(memo)),
        lambda: B.batch_verify_each_points(entries, message_points=dict(memo)),
        lambda: B._scale_entries(entries, [3]),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
