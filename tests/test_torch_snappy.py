"""The port's snappy against the JAX package's, byte for byte.

The same seeded inputs go through both packages' raw block and framed
formats: each output must be equal, each side must decompress the other's,
CRC32C must agree, and the malformed inputs of ``tests/unit/test_snappy.py``
and ``tests/unit/test_frame_fuzz.py`` must raise ``SnappyError`` on both
sides (or, for fuzz bytes that happen to parse, decode to the same bytes).
"""

import random

import numpy as np
import pytest

from lambda_ethereum_consensus_tpu.compression import snappy as jax_snappy
from lambda_ethereum_consensus_tpu_torch import compression as port_compression
from lambda_ethereum_consensus_tpu_torch.compression import snappy as port_snappy


def _inputs():
    rng = np.random.default_rng(16)
    rand = lambda n: rng.integers(0, 256, n, dtype=np.uint8).tobytes()  # noqa: E731
    words = [b"attestation", b"block", b"\x00" * 7, b"root", b"slot"]
    mixed = b"".join(words[int(i)] for i in rng.integers(0, len(words), 20_000))
    return {
        "empty": b"",
        "one": b"a",
        "random_1k": rand(1000),
        "repetitive": b"deadbeef" * 10_000,
        "zeros": b"\x00" * 100_000,
        "65535": rand(65_535),
        "65536": rand(65_536),
        "65537": rand(65_537),
        "multi_fragment_mixed": mixed,
        "multi_fragment_random": rand(3 * 65_536 + 17),
    }


INPUTS = _inputs()


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_raw_block_equals_jax(name):
    data = INPUTS[name]
    ours, theirs = port_snappy.compress(data), jax_snappy.compress(data)
    assert ours == theirs
    assert jax_snappy.decompress(ours) == data
    assert port_snappy.decompress(theirs) == data


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_framed_equals_jax(name):
    data = INPUTS[name]
    ours, theirs = port_snappy.frame_compress(data), jax_snappy.frame_compress(data)
    assert ours == theirs
    assert jax_snappy.frame_decompress(ours) == data
    assert port_snappy.frame_decompress(theirs) == data


def test_crc32c_equals_jax():
    for data in [b"", b"123456789", b"\x00" * 32, *INPUTS.values()]:
        assert port_snappy.crc32c(data) == jax_snappy.crc32c(data)
    assert port_snappy.crc32c(b"123456789") == 0xE3069283


def test_read_frame_chunk_equals_jax():
    framed = port_snappy.frame_compress(INPUTS["multi_fragment_mixed"])
    pos_p = pos_j = len(port_snappy._STREAM_ID)
    while pos_p < len(framed):
        got_p, pos_p = port_snappy.read_frame_chunk(framed, pos_p)
        got_j, pos_j = jax_snappy.read_frame_chunk(framed, pos_j)
        assert (got_p, pos_p) == (got_j, pos_j)


def test_package_exports_match_jax():
    from lambda_ethereum_consensus_tpu import compression as jax_compression

    assert port_compression.__all__ == jax_compression.__all__


def _malformed():
    good = jax_snappy.compress(b"some data here")
    framed = bytearray(jax_snappy.frame_compress(b"payload payload payload"))
    framed[15] ^= 0xFF
    body = jax_snappy._masked_crc(b"x").to_bytes(4, "little") + b"y"  # wrong checksum
    return [
        ("raw", good[:-2]),
        ("raw", b"\xff\xff\xff\xff\xff\xff"),
        ("raw", bytes([12, (4 - 1) << 2]) + b"abcd" + bytes([2, 9, 0])),  # offset past output
        ("framed", b"not a snappy frame"),
        ("framed", bytes(framed)),
        ("framed", jax_snappy._STREAM_ID + b"\x01" + len(body).to_bytes(3, "little") + body),
        ("framed", jax_snappy._STREAM_ID + b"\x02\x00\x00\x00"),  # unknown chunk type
    ]


@pytest.mark.parametrize("case", range(len(_malformed())))
def test_malformed_inputs_raise_on_both_sides(case):
    kind, blob = _malformed()[case]
    for module in (port_snappy, jax_snappy):
        fn = module.decompress if kind == "raw" else module.frame_decompress
        with pytest.raises(module.SnappyError):
            fn(blob)


def test_fuzz_bytes_agree_with_jax():
    """``test_frame_fuzz.py``'s snappy cases: random bytes into the raw
    decoder and the frame-chunk reader raise ``SnappyError`` on both sides
    or decode to the same value, and random plaintexts compress equally."""
    rng = random.Random(16)

    def garbage(n):
        return bytes(rng.getrandbits(8) for _ in range(rng.randrange(n)))

    def outcome(fn, *args):
        try:
            return fn(*args)
        except Exception as e:  # noqa: BLE001 - the class is compared below
            return type(e).__name__

    raised = 0
    for _ in range(200):
        blob = garbage(120)
        for name in ("decompress", "read_frame_chunk"):
            args = (blob,) if name == "decompress" else (blob, 0)
            got = outcome(getattr(port_snappy, name), *args)
            assert got == outcome(getattr(jax_snappy, name), *args)
            assert not isinstance(got, str) or got == "SnappyError"
            raised += isinstance(got, str)
        plain = garbage(200)
        assert port_snappy.compress(plain) == jax_snappy.compress(plain)
        assert port_snappy.decompress(port_snappy.compress(plain)) == plain
    assert raised > 300  # random bytes are nearly always malformed
