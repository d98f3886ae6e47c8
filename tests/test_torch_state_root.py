"""The slice end to end: a seeded BeaconState carried across as SSZ bytes,
its root through the port's device backend (plain PyTorch version on the
CPU) against the JAX package's device backend and hashlib.

``threshold=0`` and ``tree_threshold=0`` send every level and every subtree
through the device path; with the default thresholds states this small
would be hashed entirely by hashlib on both sides and prove nothing.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from lambda_ethereum_consensus_tpu.ops import sha256 as jops
from lambda_ethereum_consensus_tpu.ssz.hash import HashlibBackend as JaxHashlibBackend
from lambda_ethereum_consensus_tpu.types import beacon as jbeacon
from lambda_ethereum_consensus_tpu_torch import convert
from lambda_ethereum_consensus_tpu_torch import config as pconfig
from lambda_ethereum_consensus_tpu_torch.ops import sha256 as pops
from lambda_ethereum_consensus_tpu_torch.ssz import HashlibBackend

from .test_torch_ssz import random_value

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "lambda_ethereum_consensus_tpu_torch"

_REGISTRY_LISTS = (
    "validators",
    "balances",
    "previous_epoch_participation",
    "current_epoch_participation",
    "inactivity_scores",
)


@pytest.mark.parametrize(
    "preset,n_validators",
    # 64+ validators take the batched per-field route (_element_roots_batched)
    [("minimal", 256), ("mainnet", 128)],
)
def test_state_root_matches_jax(preset, n_validators, request):
    jspec = request.getfixturevalue(preset)
    pspec = getattr(pconfig, f"{preset}_spec")()
    rng = np.random.default_rng(n_validators)
    state = random_value(
        jbeacon.BeaconState, jspec, rng, lengths=dict.fromkeys(_REGISTRY_LISTS, n_validators)
    )
    ported = convert.state_from_ssz(state.encode(jspec), pspec)
    assert len(ported.validators) == n_validators

    backend = pops.DeviceHashBackend(device="cpu", threshold=0, tree_threshold=0)
    got = ported.hash_tree_root(pspec, backend=backend)
    assert backend.subtree_calls > 0
    jax_device = state.hash_tree_root(jspec, backend=jops.DeviceHashBackend(threshold=0, tree_threshold=0))
    assert got == jax_device == state.hash_tree_root(jspec, backend=JaxHashlibBackend())
    assert ported.hash_tree_root(pspec, backend=HashlibBackend()) == got


def test_port_imports_and_runs_without_jax():
    """The whole package imports, and a root is computed through the
    installed device backend, with jax and the JAX package blocked."""
    code = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["lambda_ethereum_consensus_tpu"] = None
import lambda_ethereum_consensus_tpu_torch as port
for mod in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(mod.name)
from lambda_ethereum_consensus_tpu_torch.config import minimal_spec
from lambda_ethereum_consensus_tpu_torch.ops.sha256 import install_device_backend
from lambda_ethereum_consensus_tpu_torch.types import BeaconBlockHeader
install_device_backend(device="cpu", threshold=0, tree_threshold=0)
header = BeaconBlockHeader(slot=7, proposer_index=3, parent_root=b"\\x01" * 32)
print(header.hash_tree_root(minimal_spec()).hex())
assert not any(m == "jax" or m.startswith(("jax.", "lambda_ethereum_consensus_tpu."))
               for m, v in sys.modules.items() if v is not None)
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    from lambda_ethereum_consensus_tpu.config import minimal_spec

    want = jbeacon.BeaconBlockHeader(slot=7, proposer_index=3, parent_root=b"\x01" * 32)
    assert out.stdout.strip() == want.hash_tree_root(minimal_spec()).hex()


_JAX_PACKAGE_IMPORT = re.compile(
    r"^\s*(?:from|import)\s+lambda_ethereum_consensus_tpu(?:\.|\s|$)"
    r"|import_module\(\s*[\"']lambda_ethereum_consensus_tpu(?:\.|[\"'])"
    r"|^\s*(?:from|import)\s+jax(?:\.|\s|$)",
    re.M,
)


def test_no_import_of_jax_or_the_jax_package():
    sources = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 15
    for path in sources:
        hits = _JAX_PACKAGE_IMPORT.findall(path.read_text())
        assert not hits, f"{path.relative_to(REPO)} imports {hits}"
    # the pattern must not be fooled by the port's own name
    assert not _JAX_PACKAGE_IMPORT.search("import lambda_ethereum_consensus_tpu_torch.ops")
    assert _JAX_PACKAGE_IMPORT.search("from lambda_ethereum_consensus_tpu.ssz import hash")
