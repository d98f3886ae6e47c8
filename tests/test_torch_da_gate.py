"""The port's data-availability gate against the JAX package's.

The same sequences of ``expect`` / ``on_sidecar`` / ``is_available`` /
``pending_count`` / ``expected_commitment`` calls run through
``da.availability.DataAvailability`` of both packages: the JAX gate's own
scenarios (every column, sampling subnets, orphans that arrive before their
block, a forged orphan, duplicates, out-of-range indices, idempotent
re-registration, eviction at a bound of 3 pending roots, ``DaError`` on a
reordered or truncated versioned-hash list) and seeded random sequences
over a few roots.  Each package's default registry is swapped for a fresh
one per test and the gates share one scripted clock, so the three registry
families (``da_sidecars_total{result}``, ``da_gate_wait_seconds``,
``da_blocks_pending``) compare exactly as Prometheus text.  The bound is the
JAX package's ``DA_PENDING_MAX`` environment variable and the port's
module constant ``DEFAULT_PENDING_MAX``, each set to the same value.
Tolerance: none.
"""

import numpy as np
import pytest

from lambda_ethereum_consensus_tpu import telemetry as jtel
from lambda_ethereum_consensus_tpu.config import minimal_spec as jax_minimal_spec
from lambda_ethereum_consensus_tpu.da import availability as javail
from lambda_ethereum_consensus_tpu.da.kzg import versioned_hash as jax_versioned_hash
from lambda_ethereum_consensus_tpu_torch import telemetry as ptel
from lambda_ethereum_consensus_tpu_torch.config import minimal_spec
from lambda_ethereum_consensus_tpu_torch.da import DaError, DataAvailability
from lambda_ethereum_consensus_tpu_torch.da import availability as pavail
from lambda_ethereum_consensus_tpu_torch.da.kzg import versioned_hash

SPECS = {"jax": jax_minimal_spec(), "port": minimal_spec()}
GATES = {"jax": javail.DataAvailability, "port": DataAvailability}


def _commitments(n, base=1):
    return [bytes([i]) * 48 for i in range(base, base + n)]


def _root(i):
    return bytes([i]) * 32


class _Clock:
    """Scripted monotonic clock: 100.0, then +0.75 s a read."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.75
        return self.t


@pytest.fixture(autouse=True)
def _fresh_registries(monkeypatch):
    monkeypatch.setattr(jtel, "_DEFAULT", jtel.Metrics(enabled=True))
    monkeypatch.setattr(ptel, "_DEFAULT", ptel.Metrics(enabled=True))


def _da_text(tel) -> str:
    """The ``da_*`` families of one package's default registry, as text."""
    keep = []
    for line in tel.get_metrics().render_prometheus(self_scrape=False).splitlines():
        name = line.split()[2] if line.startswith("#") else line.split("{")[0].split()[0]
        if name.startswith("da_"):
            keep.append(line)
    return "\n".join(keep)


def _run(name: str, ops, **kwargs):
    """Apply ``ops`` to a fresh gate of package ``name``; one result per op,
    an exception as ``(type name, message)``."""
    gate = GATES[name](SPECS[name], clock=_Clock(), **kwargs)
    out = []
    for op, *args in ops:
        try:
            if op == "expect":
                root, comms, hashes = args
                got = gate.expect(root, comms, versioned_hashes=hashes)
            elif op == "sidecar":
                got = gate.on_sidecar(*args)
            elif op == "available":
                got = gate.is_available(*args)
            elif op == "pending":
                got = gate.pending_count()
            else:
                got = gate.expected_commitment(*args)
        except Exception as e:  # noqa: BLE001 - the exception is the result
            got = (type(e).__name__, str(e))
        out.append(got)
    return out


def _both(ops, **kwargs):
    want = _run("jax", ops, **kwargs)
    got = _run("port", ops, **kwargs)
    assert got == want
    assert _da_text(ptel) == _da_text(jtel)
    return got


def _hashes(comms):
    return [versioned_hash(c) for c in comms]


SCENARIOS = {
    "every column": [
        ("available", _root(1)),
        ("expect", _root(1), _commitments(3), None),
        ("available", _root(1)),
        ("sidecar", _root(1), 0, _commitments(3)[0]),
        ("sidecar", _root(1), 1, _commitments(3)[1]),
        ("pending",),
        ("expected", _root(1), 2),
        ("expected", _root(1), 7),
        ("sidecar", _root(1), 2, _commitments(3)[2]),
        ("available", _root(1)),
        ("pending",),
        ("expect", _root(2), [], None),
        ("available", _root(2)),
    ],
    "mismatch and duplicates": [
        ("expect", _root(1), _commitments(2), None),
        ("sidecar", _root(1), 0, b"\xff" * 48),
        ("sidecar", _root(1), 5, _commitments(2)[0]),
        ("sidecar", _root(1), 0, _commitments(2)[0]),
        ("sidecar", _root(1), 0, _commitments(2)[0]),
        ("expect", _root(1), _commitments(2), None),
        ("sidecar", _root(1), 1, _commitments(2)[1]),
        ("sidecar", _root(1), 1, _commitments(2)[1]),
        ("expect", _root(1), _commitments(2), None),
        ("available", _root(1)),
    ],
    "orphans before the block": [
        ("sidecar", _root(1), 0, _commitments(2)[0]),
        ("sidecar", _root(1), 1, _commitments(2)[1]),
        ("sidecar", _root(1), 1, _commitments(2)[1]),
        ("expect", _root(1), _commitments(2), None),
        ("sidecar", _root(2), 0, b"\xee" * 48),
        ("expect", _root(2), _commitments(1), None),
        ("available", _root(2)),
        ("sidecar", _root(2), 0, _commitments(1)[0]),
        ("available", _root(2)),
    ],
    "versioned hashes": [
        ("expect", _root(1), _commitments(2), _hashes(_commitments(2))),
        ("expect", _root(2), _commitments(2), list(reversed(_hashes(_commitments(2))))),
        ("expect", _root(3), _commitments(2), _hashes(_commitments(2))[:1]),
        ("available", _root(2)),
        ("pending",),
    ],
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scenarios_agree(scenario):
    _both(SCENARIOS[scenario])


def test_versioned_hash_mismatch_raises_da_error():
    got = _both(SCENARIOS["versioned hashes"])
    assert got[1] == got[2] == ("DaError", "versioned hashes do not match commitments")
    assert issubclass(DaError, ValueError)
    assert [versioned_hash(c) for c in _commitments(3)] == \
        [jax_versioned_hash(c) for c in _commitments(3)]


@pytest.mark.parametrize("subnets", [(3, 4, 5), (0,), (1, 4)])
def test_sampling_subnets_agree(subnets):
    comms = _commitments(6)
    ops = [("expect", _root(1), comms[:3], None), ("available", _root(1)),
           ("expect", _root(2), comms, None), ("available", _root(2))]
    ops += [("sidecar", _root(2), i, comms[i]) for i in range(6)]
    ops += [("available", _root(2)), ("pending",)]
    got = _both(ops, subnets=subnets)
    if subnets == (0,):
        assert got[4] == "complete"


def test_eviction_at_the_pending_bound(monkeypatch):
    monkeypatch.setenv("DA_PENDING_MAX", "3")
    monkeypatch.setattr(pavail, "DEFAULT_PENDING_MAX", 3)
    comms = _commitments(1)
    ops = [("expect", _root(i), comms, None) for i in range(1, 6)]
    ops += [("pending",)] + [("available", _root(i)) for i in range(1, 6)]
    # the orphan buffer is bounded the same way
    ops += [("sidecar", _root(20 + i), 0, comms[0]) for i in range(5)]
    ops += [("expect", _root(20), comms, None), ("expect", _root(24), comms, None)]
    got = _both(ops)
    assert got[5] == 3 and got[6:11] == [True, True, False, False, False]
    assert got[-2:] == [False, True]  # root 20's orphan was evicted, 24's kept
    assert ptel.get_metrics().get("da_sidecars_total", result="evicted") == 3


def test_gate_wait_on_the_pinned_clock():
    comms = _commitments(2)
    ops = [("expect", _root(1), comms, None), ("sidecar", _root(1), 0, comms[0]),
           ("sidecar", _root(1), 1, comms[1])]
    _both(ops)
    hist = ptel.get_metrics().get_histogram("da_gate_wait_seconds")
    assert hist[3] == 1 and hist[2] == pytest.approx(0.75)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_sequences_agree(monkeypatch, seed):
    monkeypatch.setenv("DA_PENDING_MAX", "4")
    monkeypatch.setattr(pavail, "DEFAULT_PENDING_MAX", 4)
    rng = np.random.default_rng(seed)
    comms = {r: _commitments(int(rng.integers(0, 5)), base=8 * r + 1) for r in range(1, 9)}
    ops = []
    for _ in range(200):
        r = int(rng.integers(1, 9))
        kind = rng.random()
        if kind < 0.2:
            hashes = _hashes(comms[r]) if rng.random() < 0.5 else None
            ops.append(("expect", _root(r), comms[r], hashes))
        elif kind < 0.8:
            i = int(rng.integers(0, 6))
            good = i < len(comms[r]) and rng.random() < 0.85
            ops.append(("sidecar", _root(r), i, comms[r][i] if good else b"\x99" * 48))
        elif kind < 0.9:
            ops.append(("available", _root(r)))
        else:
            ops.append(("pending",))
    subnets = None if seed % 2 == 0 else (0, 2, 4)
    _both(ops, subnets=subnets)
