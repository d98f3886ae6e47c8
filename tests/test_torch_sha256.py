"""The port's SHA-256 (plain PyTorch version, wrapper, subtree reduction)
against the JAX package's plain reference and hashlib, bit for bit.

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against :func:`hash_blocks_torch` there, and the ``cuda``-marked test below
does the same where a card is present.
"""

import hashlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lambda_ethereum_consensus_tpu.ops import sha256 as jops
from lambda_ethereum_consensus_tpu.ssz import merkleize_chunks as jax_merkleize_chunks
from lambda_ethereum_consensus_tpu.ssz.hash import HashlibBackend as JaxHashlibBackend
from lambda_ethereum_consensus_tpu_torch.ops import sha256 as pops
from lambda_ethereum_consensus_tpu_torch.ssz import merkleize_chunks

_CU = Path(pops.__file__).resolve().parent.parent / "csrc" / "sha256.cu"


def _oracle(blocks: np.ndarray) -> np.ndarray:
    out = np.zeros((blocks.shape[0], 32), np.uint8)
    for i, row in enumerate(blocks):
        out[i] = np.frombuffer(hashlib.sha256(row.tobytes()).digest(), np.uint8)
    return out


def _jax_plain(blocks: np.ndarray) -> np.ndarray:
    words = np.ascontiguousarray(blocks).view(">u4").astype(np.uint32)
    digests = np.asarray(jops.hash_blocks_jnp(words))
    return np.ascontiguousarray(digests.astype(">u4")).view(np.uint8).reshape(-1, 32)


def _blocks(n: int) -> np.ndarray:
    if n == 0:
        return np.zeros((4, 64), np.uint8)  # the all-zero batch
    return np.random.default_rng(n).integers(0, 256, size=(n, 64), dtype=np.uint8)


@pytest.mark.parametrize("n", [0, 1, 2, 7, 128, 1000], ids=lambda n: "zeros" if n == 0 else str(n))
def test_plain_version_matches_jax_and_hashlib(n):
    blocks = _blocks(n)
    want = _oracle(blocks)
    assert np.array_equal(_jax_plain(blocks), want)
    assert np.array_equal(jops.hash_blocks(blocks), want)
    got_torch = pops.hash_blocks_torch(torch.from_numpy(blocks))
    assert got_torch.dtype == torch.uint8 and tuple(got_torch.shape) == (len(blocks), 32)
    assert np.array_equal(got_torch.numpy(), want)
    assert np.array_equal(pops.hash_blocks(blocks, device="cpu"), want)


@pytest.mark.parametrize("n", [1, 3, 8, 515])
def test_backend_hash_level(n):
    blocks = _blocks(n)
    backend = pops.DeviceHashBackend(device="cpu", threshold=0)
    assert np.array_equal(backend.hash_level(blocks), _oracle(blocks))


@pytest.mark.parametrize("count,limit", [(1, 1), (2, 4), (5, 8), (600, 1024), (1000, 1 << 40)])
def test_merkleize_matches_jax(count, limit):
    chunks = np.random.default_rng(count).integers(0, 256, size=(count, 32), dtype=np.uint8)
    jax_device = jax_merkleize_chunks(
        chunks, limit, backend=jops.DeviceHashBackend(threshold=0, tree_threshold=0)
    )
    port = pops.DeviceHashBackend(device="cpu", threshold=0, tree_threshold=0)
    got = merkleize_chunks(chunks, limit, backend=port)
    assert got == jax_device == jax_merkleize_chunks(chunks, limit, backend=JaxHashlibBackend())
    assert port.subtree_calls == (1 if limit > 1 else 0)


@pytest.mark.parametrize("count", [1, 2, 5, 600, 1000])
def test_merkle_root_device_matches_jax(count):
    chunks = np.random.default_rng(count).integers(0, 256, size=(count, 32), dtype=np.uint8)
    assert pops.merkle_root_device(chunks, device="cpu") == jops.merkle_root_device(chunks)


def _cu_array(name: str) -> list[int]:
    m = re.search(rf"__constant__ uint32_t {name}\[(\d+)\] = \{{(.*?)\}};", _CU.read_text(), re.S)
    assert m, f"{name} not found in {_CU.name}"
    values = [int(v, 16) for v in re.findall(r"0x[0-9A-Fa-f]+", m.group(2))]
    assert len(values) == int(m.group(1))
    return values


def test_cuda_constants_match_python():
    assert _cu_array("kK") == pops._K == jops._K
    assert _cu_array("kIV") == pops._IV == jops._IV
    pad = pops._py_schedule([0x80000000] + [0] * 14 + [512])
    assert _cu_array("kPadSchedule") == pad == pops._PAD_SCHEDULE == jops._PAD_SCHEDULE


@pytest.mark.parametrize(
    "bad",
    [
        torch.zeros((4, 64), dtype=torch.int32),
        torch.zeros((4, 32), dtype=torch.uint8),
        torch.zeros((4, 64, 1), dtype=torch.uint8),
        torch.zeros(64, dtype=torch.uint8),
        torch.zeros((64, 4), dtype=torch.uint8).t(),
    ],
    ids=["int32", "width32", "rank3", "rank1", "strided"],
)
def test_wrapper_rejects_bad_input(bad):
    launches = pops.sha256_kernel_launches
    with pytest.raises(ValueError):
        pops.sha256_nodes(bad)
    assert pops.sha256_kernel_launches == launches


def test_cpu_path_counts_no_launch():
    launches = pops.sha256_kernel_launches
    pops.sha256_nodes(torch.zeros((3, 64), dtype=torch.uint8))
    assert pops.sha256_kernel_launches == launches


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    blocks = _blocks(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pops.DeviceHashBackend()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pops.install_device_backend()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pops.hash_blocks(blocks)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pops.merkle_root_device(blocks.reshape(-1, 32))
    assert pops.DeviceHashBackend(device="cpu").device.type == "cpu"


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py runs this check on the card")
    for n in (1, 7, 255, 1000, 1 << 16):
        blocks = torch.from_numpy(_blocks(n)).cuda()
        before = pops.sha256_kernel_launches
        got = pops.sha256_nodes(blocks)
        torch.cuda.synchronize()
        assert pops.sha256_kernel_launches == before + 1
        assert torch.equal(got, pops.hash_blocks_torch(blocks))
