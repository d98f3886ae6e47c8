"""Every module of the port imports with ``jax`` and the JAX package blocked.

A fresh interpreter sets ``sys.modules["jax"]`` (and ``jaxlib``) and
``sys.modules["lambda_ethereum_consensus_tpu"]`` to ``None``, so any import of
them raises, then imports every module under
``lambda_ethereum_consensus_tpu_torch`` — without building or loading the
native host libraries (BLS12-381 and the key-value engine), which happens at
first use.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "lambda_ethereum_consensus_tpu"):
    sys.modules[name] = None
import lambda_ethereum_consensus_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from lambda_ethereum_consensus_tpu_torch.crypto.bls import native
assert native._loaded is None, "importing loaded the native library"
from lambda_ethereum_consensus_tpu_torch.store import kv
assert kv._NATIVE is None, "importing loaded the native kvstore library"
print("\\n".join(names))
"""


def test_port_imports_without_jax_or_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    prefix = "lambda_ethereum_consensus_tpu_torch."
    for module in (
        "crypto.bls.api", "crypto.bls.batch", "crypto.bls.native", "da.availability",
        "da.kzg",
        "fork_choice", "fork_choice.attestation", "fork_choice.forensics",
        "fork_choice.handlers", "fork_choice.head",
        "fork_choice.store", "fork_choice.tree", "ops.bls_batch", "ops.rlc",
        "ops.bls_g1", "ops.bls_g2", "ops.bls_pairing", "ops.bls_sign", "ops.sha256",
        "ssz.core", "ssz.incremental", "types.beacon",
        "state_transition.accessors", "state_transition.core", "state_transition.epoch",
        "state_transition.errors", "state_transition.genesis", "state_transition.math",
        "state_transition.misc", "state_transition.mutable", "state_transition.mutators",
        "state_transition.operations", "state_transition.predicates",
        "state_transition.resident", "validator.duties",
        "node", "node.__main__", "node.chain", "node.node", "node.pending_blocks",
        "node.replay", "node.sync", "node.telemetry", "node.warmup", "ops.profile",
        "ops._build", "pipeline", "pipeline.lanes", "pipeline.policy",
        "pipeline.scheduler", "store", "store.block_store", "store.kv", "store.state_store",
        "telemetry", "tracing", "utils.env", "validator.harness", "validator.pool",
        "validator.scheduler",
        "serve_cache", "witness", "witness.coalesce", "witness.multiproof",
        "compression", "compression.snappy", "faults", "network", "network.gossip",
        "network.noise", "network.peerbook", "network.port", "network.proto",
        "network.proto.p2p_pb2", "network.proto.port_pb2", "network.reqresp",
        "network.sidecar", "network.sidecar_libp2p", "network.proto.gossipsub_pb2",
        "network.libp2p", "network.libp2p.varint", "network.libp2p.multistream",
        "network.libp2p.identity", "network.libp2p.noise_transport", "network.libp2p.mplex",
        "network.libp2p.yamux", "network.libp2p.host", "network.libp2p.gossipsub",
        "witness.service", "witness.vector_commitment", "witness.verify",
        "slo", "api", "api.beacon_api", "api.checkpoint_sync", "api.engine", "api.harness",
    ):
        assert prefix + module in names
