"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any mismatch or exception ends the run with a nonzero exit):

1. the card's name and power limit, and the kernels built from ``csrc/``;
2. every kernel against its plain PyTorch version on the card, bit for bit,
   at the main path's shapes, plus a hashlib sample; kernel and plain
   version timed with CUDA events;
3. the slice: ``BeaconState.hash_tree_root`` of a mainnet-preset state with
   1,000,000 seeded validators through ``install_device_backend()``, cold and
   warm, each equal to the hashlib root of the same state, with the kernel's
   launch count read around each root;
4. one JSON line of per-kernel numbers, then the device line last.

Needs one card, ``nvcc`` and ``cuobjdump``; exits nonzero without a card.
"""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 20261016
N_VALIDATORS = 1_000_000
CHECK_SIZES = (1, 7, 255, 1000, 1 << 20)
TIMED_SIZES = (1 << 20, 8_000_000)

# H100 SXM, from the data sheet and the Hopper white paper: HBM3 rate, SMs,
# INT32 lanes per SM (the ALU pipe) and thread-instructions an SM can issue
# per clock (4 schedulers x 32 lanes; IMAD issues on the FP32/FMA pipe, so
# only the ALU-pipe share is held to 64 lanes)
HBM_BYTES_PER_S = 3.35e12
SMS = 132
INT32_LANES_PER_SM = 64
DISPATCH_LANES_PER_SM = 128
# SASS opcodes that run only on the INT32 ALU pipe
_ALU_OPCODES = {
    "IADD3", "IADD", "IADD32I", "LOP3", "LOP", "LOP32I", "SHF", "SHL", "SHR",
    "PRMT", "LEA", "ISETP", "SEL", "IMNMX", "BMSK", "IABS", "POPC", "FLO", "BREV",
}


def _smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]


def _event_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _sass_opcodes(lib: Path, kernel: str) -> Counter:
    """Opcode histogram of ``kernel``'s SASS (NOPs left out).  The kernel is
    straight-line code, so the static count is what one in-range thread
    executes."""
    from lambda_ethereum_consensus_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or str(Path(_build.nvcc_path()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], check=True, capture_output=True, text=True).stdout
    sections = re.split(r"^\s*Function : ", sass, flags=re.M)
    body = next(s for s in sections[1:] if kernel in s.splitlines()[0])
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", body)
    return Counter(op for op in ops if op != "NOP")


def _op_ms(opcodes: Counter, n: int, clock_mhz: float) -> float:
    """Least time for ``n`` hashes by instruction issue: the ALU-pipe
    instructions over 64 lanes per SM, all of them over 128."""
    alu = sum(c for op, c in opcodes.items() if op in _ALU_OPCODES)
    lane_clocks = max(alu / INT32_LANES_PER_SM, sum(opcodes.values()) / DISPATCH_LANES_PER_SM)
    return lane_clocks * n / (SMS * clock_mhz * 1e6) * 1e3


def build_state(spec, n: int, seed: int):
    """A mainnet-preset BeaconState with ``n`` seeded validators."""
    from lambda_ethereum_consensus_tpu_torch import ssz
    from lambda_ethereum_consensus_tpu_torch.config import constants
    from lambda_ethereum_consensus_tpu_torch.types import (
        BeaconBlockHeader, BeaconState, Checkpoint, Eth1Data, ExecutionPayloadHeader, Fork,
        HistoricalSummary, SyncCommittee, Validator,
    )

    rng = np.random.default_rng(seed)

    def rows(count: int, width: int) -> list[bytes]:
        raw = rng.integers(0, 256, (count, width), dtype=np.uint8).tobytes()
        return [raw[i * width:(i + 1) * width] for i in range(count)]

    far = constants.FAR_FUTURE_EPOCH
    pubkeys = rows(n, 48)
    creds = rows(n, 32)
    effective = (rng.integers(16, 33, n) * 10**9).tolist()
    eligibility = rng.integers(0, 250_000, n)
    activation = (eligibility + rng.integers(1, 5, n)).tolist()
    exiting = rng.random(n) < 0.01
    exit_epoch = np.where(exiting, eligibility + 300_000, 0).tolist()
    slashed = (rng.random(n) < 0.001).tolist()
    eligibility = eligibility.tolist()
    validators = [
        Validator(
            pubkey=pubkeys[i],
            withdrawal_credentials=creds[i],
            effective_balance=effective[i],
            slashed=slashed[i],
            activation_eligibility_epoch=eligibility[i],
            activation_epoch=activation[i],
            exit_epoch=exit_epoch[i] or far,
            withdrawable_epoch=exit_epoch[i] + 256 if exit_epoch[i] else far,
        )
        for i in range(n)
    ]
    balances = (np.asarray(effective) + rng.integers(0, 10**8, n)).tolist()
    sync = SyncCommittee(
        pubkeys=[pubkeys[i] for i in rng.integers(0, n, spec.SYNC_COMMITTEE_SIZE)],
        aggregate_pubkey=rows(1, 48)[0],
    )
    slot = 9_000_000
    epoch = slot // spec.SLOTS_PER_EPOCH
    return BeaconState(
        genesis_time=1606824023,
        genesis_validators_root=rows(1, 32)[0],
        slot=slot,
        fork=Fork(previous_version=spec.BELLATRIX_FORK_VERSION,
                  current_version=spec.CAPELLA_FORK_VERSION, epoch=spec.CAPELLA_FORK_EPOCH),
        latest_block_header=BeaconBlockHeader(slot=slot, proposer_index=17,
                                              parent_root=rows(1, 32)[0], body_root=rows(1, 32)[0]),
        block_roots=rows(spec.SLOTS_PER_HISTORICAL_ROOT, 32),
        state_roots=rows(spec.SLOTS_PER_HISTORICAL_ROOT, 32),
        historical_roots=rows(758, 32),
        eth1_data=Eth1Data(deposit_root=rows(1, 32)[0], deposit_count=n, block_hash=rows(1, 32)[0]),
        eth1_data_votes=[Eth1Data(deposit_root=r, deposit_count=n, block_hash=r)
                         for r in rows(100, 32)],
        eth1_deposit_index=n,
        validators=validators,
        balances=balances,
        randao_mixes=rows(spec.EPOCHS_PER_HISTORICAL_VECTOR, 32),
        slashings=rng.integers(0, 10**10, spec.EPOCHS_PER_SLASHINGS_VECTOR).tolist(),
        previous_epoch_participation=rng.integers(0, 8, n).tolist(),
        current_epoch_participation=rng.integers(0, 8, n).tolist(),
        justification_bits=ssz.BitvectorValue.from_bools([1, 1, 1, 0]),
        previous_justified_checkpoint=Checkpoint(epoch=epoch - 2, root=rows(1, 32)[0]),
        current_justified_checkpoint=Checkpoint(epoch=epoch - 1, root=rows(1, 32)[0]),
        finalized_checkpoint=Checkpoint(epoch=epoch - 2, root=rows(1, 32)[0]),
        inactivity_scores=rng.integers(0, 50, n).tolist(),
        current_sync_committee=sync,
        next_sync_committee=sync,
        latest_execution_payload_header=ExecutionPayloadHeader(
            parent_hash=rows(1, 32)[0], fee_recipient=rows(1, 20)[0], state_root=rows(1, 32)[0],
            receipts_root=rows(1, 32)[0], logs_bloom=rows(1, spec.BYTES_PER_LOGS_BLOOM)[0],
            prev_randao=rows(1, 32)[0], block_number=18_000_000, gas_limit=30_000_000,
            gas_used=12_345_678, timestamp=1_700_000_000, extra_data=b"chip-smoke",
            base_fee_per_gas=7 * 10**9, block_hash=rows(1, 32)[0],
            transactions_root=rows(1, 32)[0], withdrawals_root=rows(1, 32)[0],
        ),
        next_withdrawal_index=42_000_000,
        next_withdrawal_validator_index=123_456,
        historical_summaries=[HistoricalSummary(block_summary_root=r, state_summary_root=r)
                              for r in rows(200, 32)],
    )


class _TimedBackend:
    """Wall time spent inside a backend's calls (copies, launches and the
    synchronising copy back), to split a root into host and device work."""

    def __init__(self, inner):
        self.inner = inner
        self.tree_threshold = inner.tree_threshold
        self.seconds = 0.0

    def hash_level(self, blocks):
        t = time.perf_counter()
        try:
            return self.inner.hash_level(blocks)
        finally:
            self.seconds += time.perf_counter() - t

    def merkle_subtree_root(self, chunks):
        t = time.perf_counter()
        try:
            return self.inner.merkle_subtree_root(chunks)
        finally:
            self.seconds += time.perf_counter() - t


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from lambda_ethereum_consensus_tpu_torch.config import mainnet_spec
    from lambda_ethereum_consensus_tpu_torch.ops import _build
    from lambda_ethereum_consensus_tpu_torch.ops import sha256 as sops
    from lambda_ethereum_consensus_tpu_torch.ssz import HashlibBackend, set_hash_backend

    # ---- phase 1: the card and the build
    card = _smi("name,power.limit")
    clock_mhz = float(_smi("clocks.max.sm").split()[0])
    print(card)
    print(f"max SM clock {clock_mhz:.0f} MHz")
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernels built in {build_s:.2f} s: {sorted(libs)}")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")

    # ---- phase 2: the kernel against its plain version, on the card
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    max_err = 0
    batches = [rng.integers(0, 256, (n, 64), dtype=np.uint8) for n in CHECK_SIZES]
    batches.append(np.zeros((4, 64), np.uint8))
    for host in batches:
        blocks = torch.from_numpy(host).to(dev)
        got = sops.sha256_nodes(blocks)
        plain = sops.hash_blocks_torch(blocks)
        torch.cuda.synchronize()
        err = int((got.to(torch.int16) - plain.to(torch.int16)).abs().max().item())
        max_err = max(max_err, err)
        if err or not torch.equal(got, plain):
            raise AssertionError(f"kernel != plain version at N={len(host)} (max abs err {err})")
        print(f"kernel == plain version at N={len(host)}")
    big = batches[len(CHECK_SIZES) - 1]
    got_big = sops.sha256_nodes(torch.from_numpy(big).to(dev)).cpu().numpy()
    for i in rng.choice(len(big), 4096, replace=False):
        if got_big[i].tobytes() != hashlib.sha256(big[i].tobytes()).digest():
            raise AssertionError(f"kernel != hashlib at row {i}")
    print("kernel == hashlib on a 4096-row sample")

    opcodes = _sass_opcodes(libs["sha256"], "sha256_nodes_kernel")
    timings = {}
    for n in TIMED_SIZES:
        blocks = torch.from_numpy(rng.integers(0, 256, (n, 64), dtype=np.uint8)).to(dev)
        kernel_ms = _event_ms(lambda: sops.sha256_nodes(blocks), reps=20)
        plain_ms = _event_ms(lambda: sops.hash_blocks_torch(blocks), reps=3, warmup=1)
        byte_ms = 96 * n / HBM_BYTES_PER_S * 1e3
        op_ms = _op_ms(opcodes, n, clock_mhz)
        timings[n] = dict(kernel_ms=kernel_ms, plain_ms=plain_ms, byte_ms=byte_ms, op_ms=op_ms,
                          bound_ms=max(byte_ms, op_ms))
        print(f"N={n}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.2f} ms, "
              f"bound {max(byte_ms, op_ms):.4f} ms (bytes {byte_ms:.4f}, int ops {op_ms:.4f}); "
              f"{n / kernel_ms / 1e6:.3f} G hashes/s")
        del blocks
    alu = sum(c for op, c in opcodes.items() if op in _ALU_OPCODES)
    print(f"SASS per hash: {sum(opcodes.values())} instructions, {alu} on the ALU pipe; "
          f"{dict(opcodes.most_common())}")

    # ---- phase 3: the slice — a 1M-validator mainnet state root on the card
    spec = mainnet_spec()
    t0 = time.perf_counter()
    state = build_state(spec, N_VALIDATORS, SEED)
    setup_s = time.perf_counter() - t0
    print(f"setup: {N_VALIDATORS} validators built in {setup_s:.1f} s")
    backend = sops.install_device_backend()
    roots, seconds, launches = [], [], []
    for _ in ("cold", "warm"):
        sops.sha256_kernel_launches = 0
        t0 = time.perf_counter()
        roots.append(state.hash_tree_root(spec))
        seconds.append(time.perf_counter() - t0)
        launches.append(sops.sha256_kernel_launches)
    subtree_calls = backend.subtree_calls
    timed = _TimedBackend(backend)
    t0 = time.perf_counter()
    timed_root = state.hash_tree_root(spec, backend=timed)
    timed_s = time.perf_counter() - t0
    set_hash_backend(HashlibBackend())
    t0 = time.perf_counter()
    reference = state.hash_tree_root(spec)
    hashlib_s = time.perf_counter() - t0
    if not roots[0] == roots[1] == timed_root == reference:
        raise AssertionError(f"device roots {[r.hex() for r in roots]} != hashlib {reference.hex()}")
    if not launches[0] or launches[0] != launches[1] or not subtree_calls:
        raise AssertionError(f"main path missed the kernel: launches {launches}, "
                             f"subtree reductions {subtree_calls}")
    print(f"state root {reference.hex()} == hashlib root ({hashlib_s:.2f} s on the host)")
    print(f"state root cold {seconds[0]:.3f} s, warm {seconds[1]:.3f} s; "
          f"{launches[1]} kernel launches per root; {subtree_calls // 2} subtree reductions per root")
    print(f"timed root {timed_s:.3f} s: {timed.seconds:.3f} s inside device backend calls, "
          f"{timed_s - timed.seconds:.3f} s host work")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")

    # ---- phase 4: per-kernel numbers, then the device line
    big_n = TIMED_SIZES[-1]
    t = timings[big_n]
    kernels = [{
        "name": "sha256",
        "route": "cuda",
        "source": "lambda_ethereum_consensus_tpu_torch/csrc/sha256.cu",
        "replaces": "lambda_ethereum_consensus_tpu/ops/sha256.py:191",
        "launches": launches[1],
        "max_abs_err": max_err,
        "n": big_n,
        "ms": t["kernel_ms"],
        "kernel_ms": t["kernel_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "operations" if t["op_ms"] >= t["byte_ms"] else "bytes",
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
