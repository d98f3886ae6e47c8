"""The port's vector commitment against the JAX package's host path.

Generators, commitments, openings, fold scalars and fold verdicts of
``witness/vector_commitment.py`` held against the JAX package's
``device=False`` route (its host Jacobian ladder); the port's own routes are
the host oracle (``host=True``: ``g1.multiply`` per term) and the plain
PyTorch version of the card's MSM (``device="cpu"``: ``batch_g1_mul`` on the
field kernels' plain versions, ~4 s per 256-bit ladder here, so only a
commitment, an opening and one fold take it).  Tolerance: none, points are
exact affine integers and verdicts booleans.
"""

import pytest
import torch

from lambda_ethereum_consensus_tpu.crypto.bls.curve import g1 as jg1
from lambda_ethereum_consensus_tpu.witness import vector_commitment as JVC
from lambda_ethereum_consensus_tpu_torch.crypto.bls.curve import g1
from lambda_ethereum_consensus_tpu_torch.witness import vector_commitment as VC


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _vectors():
    return [[(j * 13 + i) % 997 for i in range(16)] for j in range(3)]


def test_generators_equal_jax_and_lie_in_the_subgroup():
    gens = VC.generators(8)
    assert gens == JVC.generators(8)
    assert len(set(gens)) == 8
    for pt in gens:
        assert g1.on_curve(pt) and g1.in_subgroup(pt)
    assert VC.generators(8) == gens
    assert VC.generators(VC.WIDTH)[-1] == JVC.generators(VC.WIDTH)[-1]


@pytest.mark.parametrize("route", ["host", "plain"])
def test_commit_and_open_equal_jax(route):
    kw = {"host": True} if route == "host" else {"device": "cpu"}
    values = [i * 31 + 5 for i in range(12)]
    assert VC.commit(values, **kw) == JVC.commit(values, device=False)
    opening = VC.open_indices(values, [0, 7, 11], **kw)
    want = JVC.open_indices(values, [0, 7, 11], device=False)
    assert (opening.indices, opening.values, opening.rest) == (want.indices, want.values, want.rest)


def test_fold_scalars_equal_jax():
    vecs = _vectors()
    commitments = [VC.commit(v, host=True) for v in vecs]
    openings = [VC.open_indices(v, [j, j + 4], host=True) for j, v in enumerate(vecs)]
    jopenings = [JVC.VcOpening(o.indices, o.values, o.rest) for o in openings]
    assert VC._fold_scalars(commitments, openings) == JVC._fold_scalars(commitments, jopenings)


def _tampered(vecs, commitments, openings):
    """(name, commitments, openings) cases that must fail the fold."""
    bad_value = VC.VcOpening(openings[1].indices,
                             (openings[1].values[0] + 1,) + openings[1].values[1:],
                             openings[1].rest)
    bad_rest = VC.VcOpening(openings[2].indices, openings[2].values,
                            g1.affine_add(openings[2].rest, VC.generators(1)[0]))
    other = VC.commit([v + 1 for v in vecs[0]], host=True)
    return [
        ("tampered value", commitments, [openings[0], bad_value, openings[2]]),
        ("tampered rest", commitments, [openings[0], openings[1], bad_rest]),
        ("wrong commitment", [other] + commitments[1:], openings),
    ]


def _jax_verdict(commitments, openings) -> bool:
    return JVC.verify_openings(
        commitments, [JVC.VcOpening(o.indices, o.values, o.rest) for o in openings],
        device=False)


def test_fold_verdicts_equal_jax_on_the_host_route():
    vecs = _vectors()
    commitments = [VC.commit(v, host=True) for v in vecs]
    openings = [VC.open_indices(v, [j, j + 4], host=True) for j, v in enumerate(vecs)]
    assert VC.verify_openings(commitments, openings, host=True) is True
    assert _jax_verdict(commitments, openings) is True
    for name, cs, os_ in _tampered(vecs, commitments, openings):
        assert VC.verify_openings(cs, os_, host=True) is False, name
        assert _jax_verdict(cs, os_) is False, name


def test_fold_on_the_plain_msm_route():
    """One fold through ``batch_g1_mul``'s plain version: True, then False
    with one value tampered (the two ladders of the card's route)."""
    vecs = _vectors()
    commitments = [VC.commit(v, host=True) for v in vecs]
    openings = [VC.open_indices(v, [j, j + 4], host=True) for j, v in enumerate(vecs)]
    assert VC.verify_openings(commitments, openings, device="cpu") is True
    name, cs, os_ = _tampered(vecs, commitments, openings)[0]
    assert VC.verify_openings(cs, os_, device="cpu") is False


@pytest.mark.parametrize("opening", [
    VC.VcOpening((), (), None),               # empty
    VC.VcOpening((1, 2), (5,), None),         # values short of the indices
    VC.VcOpening((3, 3), (5, 5), None),       # duplicated index
    VC.VcOpening((VC.WIDTH,), (5,), None),    # past the width
    VC.VcOpening((-1,), (5,), None),          # negative
])
def test_shape_violations_reject_like_jax(opening):
    values = [1, 2, 3, 4]
    commitment = VC.commit(values, host=True)
    assert VC.verify_openings([commitment], [opening], host=True) is False
    jopening = JVC.VcOpening(opening.indices, opening.values, opening.rest)
    assert JVC.verify_openings([commitment], [jopening], device=False) is False


def test_shape_errors_raise_like_jax():
    values = [1, 2, 3, 4]
    for fn, jfn in ((lambda: VC.open_indices(values, [], host=True),
                     lambda: JVC.open_indices(values, [], device=False)),
                    (lambda: VC.open_indices(values, [9], host=True),
                     lambda: JVC.open_indices(values, [9], device=False)),
                    (lambda: VC.open_indices(values, [1, 1], host=True),
                     lambda: JVC.open_indices(values, [1, 1], device=False)),
                    (lambda: VC.commit(list(range(VC.WIDTH + 1)), host=True),
                     lambda: JVC.commit(list(range(VC.WIDTH + 1)), device=False)),
                    (lambda: VC.verify_openings([], [], host=True),
                     lambda: JVC.verify_openings([], [], device=False))):
        with pytest.raises(JVC.VcError) as jerr:
            jfn()
        with pytest.raises(VC.VcError) as perr:
            fn()
        assert str(perr.value) == str(jerr.value)


def test_zero_vector_commits_to_infinity():
    assert VC.commit([0, 0, 0], host=True) is None
    assert JVC.commit([0, 0, 0], device=False) is None
    assert VC.commit([], host=True) is None
    assert jg1.on_curve(VC.commit([1], host=True))
