"""The node phase of ``chip_smoke.py`` (3i) and the phases it stands on.

    python3 scripts/chip_node_phase.py

Runs, on one NVIDIA GPU, ``chip_smoke.py``'s phase 1 (the kernels' and the
native library's build), the 1,000,000-validator state and its root (phase
3), the transition (3b), the node's slot (3c), blob KZG (8), the ingest path
(3g) and the beacon node booted on the card (3i), with the smoke's checks,
in about half the smoke's time.  The smoke's other phases, phase 9's timings
and its JSON lines are left out.  Exits nonzero without a card.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_node_phase: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from lambda_ethereum_consensus_tpu_torch.config import mainnet_spec
    from lambda_ethereum_consensus_tpu_torch.ops import _build
    from lambda_ethereum_consensus_tpu_torch.ops import sha256 as sops

    card = cs._smi("name,power.limit")
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    cs._timed_native_load()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED)
    spec = mainnet_spec()
    keys, key_points, compressed, _ = cs.registry_keys(dev, rng)
    state = cs.build_state(spec, cs.N_VALIDATORS, cs.SEED, compressed[:cs.REGISTRY_KEYS])
    sops.install_device_backend()
    state.hash_tree_root(spec)
    record = {"card": card}
    t0 = time.perf_counter()
    transition = cs.transition_phase(dev, rng, record, state, spec)
    print(f"state-transition phase {time.perf_counter() - t0:.1f} s", flush=True)
    del state
    t0 = time.perf_counter()
    _, node_routes = cs.node_phase(dev, rng, record, spec, transition["start"],
                                   transition["start_sks"], transition["sync_keys"], keys,
                                   key_points, compressed)
    print(f"node phase {time.perf_counter() - t0:.1f} s", flush=True)
    setup = cs.kzg_setup(record)
    blobs, commitments, proofs = cs.kzg_phase(dev, rng, record, setup)
    store = node_routes["store"]
    t0 = time.perf_counter()
    cs.ingest_phase(dev, record, card, spec, store, node_routes["drain"],
                    transition["start_sks"], keys, setup, blobs, commitments, proofs)
    print(f"ingest phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    cs.node_boot_phase(dev, rng, record, card, spec, store, transition["start_sks"], keys,
                       blobs, commitments, proofs)
    print(f"node-boot phase {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
